"""The port's config loader reads a ``.json`` config as well as YAML: the
format ``save_config`` writes by default, and the one a machine without
PyYAML can give the V33 CLI's ``--config``."""

import json

import pytest

from splade_tpu_torch.config import V33Config, load_config, save_config

YAML = "configs/train_v33.yaml"


def test_json_config_reads_as_the_yaml_it_was_written_from(tmp_path):
    from_yaml = load_config(YAML)
    path = tmp_path / "resolved.json"
    save_config(from_yaml, str(path))
    assert load_config(str(path)).to_dict() == from_yaml.to_dict()


@pytest.mark.parametrize("suffix", [".json", ".yaml"])
def test_env_and_overrides_apply_over_a_config_file(tmp_path, suffix):
    """defaults < file < env < explicit overrides, whichever the format."""
    path = tmp_path / f"cfg{suffix}"
    path.write_text(json.dumps({"data": {"batch_size": 8},
                                "training": {"learning_rate": 1e-4}}))
    cfg = load_config(str(path), overrides={"loss": {"lambda_q": 0.5}},
                      environ={"TRAIN_TRAINING__LEARNING_RATE": "2e-5"})
    want = V33Config().to_dict()
    want["data"]["batch_size"] = 8
    want["training"]["learning_rate"] = 2e-5
    want["loss"]["lambda_q"] = 0.5
    assert cfg.to_dict() == want
