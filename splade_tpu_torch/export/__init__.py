from splade_tpu_torch.export.hf_export import export_checkpoint_to_hf

__all__ = ["export_checkpoint_to_hf"]
