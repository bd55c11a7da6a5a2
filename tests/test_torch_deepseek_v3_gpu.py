"""The DeepSeek-V3 backbone's card path (``models/deepseek_v3.py``): the
held experts' grouped bf16 products against the CPU path's plain loop over
the experts, and a tiny model on the card against the same model on the
CPU. Every test carries the ``gpu`` marker and skips without a CUDA
device; the file imports neither JAX nor ``splade_tpu``:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_deepseek_v3_gpu.py
"""

import pytest
import torch

from splade_tpu_torch.models.deepseek_v3 import (DeepseekV3Config,
                                                 grouped_swiglu, moe_counters,
                                                 reset_moe_counters)
from splade_tpu_torch.models.splade import SpladeEncoder

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the grouped products run on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("sizes,H,I", [
    ([5, 0, 33, 16, 1], 64, 24),          # an empty group, ragged groups
    ([1700, 1800, 1650, 1810] * 8, 2048, 768),   # 32 held experts at width
])
def test_grouped_experts_match_the_plain_loop(cuda, sizes, H, I):
    """Forward and every gradient of the grouped products against the
    plain loop on the same bf16 operands in float32 (only the products'
    rounding to bf16 and their sum order differ)."""
    g = torch.Generator().manual_seed(len(sizes))
    E, n = len(sizes), sum(sizes)
    xs = torch.randn(n, H, generator=g).to(torch.bfloat16).float()
    gu = (torch.randn(E, 2 * I, H, generator=g) * 0.02).to(
        torch.bfloat16).float()
    dn = (torch.randn(E, H, I, generator=g) * 0.02).to(
        torch.bfloat16).float()
    gout = torch.randn(n, H, generator=g)

    def run(device):
        leaves = [t.to(device).requires_grad_() for t in (xs, gu, dn)]
        out = grouped_swiglu(leaves[0], sizes, leaves[1], leaves[2])
        (out.float() * gout.to(device)).sum().backward()
        return [out.float().cpu()] + [t.grad.float().cpu() for t in leaves]

    got, want = run(cuda), run("cpu")
    for name, a, b in zip(("out", "dx", "dgate_up", "ddown"), got, want):
        assert torch.isfinite(a).all(), name
        rel = float((a - b).norm() / b.norm())
        assert rel <= 1e-2, (name, rel)


def test_tiny_model_on_the_card_matches_the_cpu(cuda):
    cfg = DeepseekV3Config.tiny(remat=True)
    model = SpladeEncoder(cfg, device="cpu").init_weights(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.endswith("norm.weight"):
                p.mul_(5.0)
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(4, 512, (6, 48), generator=g)
    mask = torch.ones_like(ids)
    mask[2, 30:] = 0
    with torch.no_grad():
        want, _ = model(ids, mask)
    model.to(cuda)
    reset_moe_counters(model)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        got, _ = model(ids.to(cuda), mask.to(cuda))
    rel = float((got.float().cpu() - want).norm() / want.norm())
    assert rel <= 3e-2, rel
    counts = moe_counters(model)
    assert counts[0]["calls"] == 1
    assert counts[0]["held_slots"] + counts[0]["offchip_slots"] == 6 * 48 * 2
