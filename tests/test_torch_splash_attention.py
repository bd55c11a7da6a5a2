"""The port's splash attention (splade_tpu_torch.ops.splash_attention) and
the models routed through it (``attention_impl="splash"``) against the JAX
package on the same numpy inputs, on the CPU in f32.

On a CPU tensor the port runs its plain versions (tile by tile, online
softmax, backward from the saved lse). They are held (a) against JAX's own
Pallas splash kernel and its VJP, run in interpret mode by wrapping
``make_splash_mha`` in this file only (nothing in ``splade_tpu`` changes),
at S = 128 and 256, the lengths that kernel takes, and against a dense
masked softmax at ragged lengths: 2e-6 on values and 5e-6 on gradients, the
order of f32 sums; (b) through the whole model against the JAX model on the
same weights, which off the TPU computes sdpa's math under either config
value (tests/test_splash_attention.py): equal at valid positions, pooled
vectors and their gradients equal, within the packed-query tests' 2e-5.
"""

import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splade_tpu.models import modernbert as jax_modernbert
from splade_tpu.models.modernbert import ModernBertConfig as JaxConfig
from splade_tpu.models.modernbert import ModernBertForMaskedLM as JaxMLM
from splade_tpu.models.splade import SpladeEncoder as JaxSplade
from splade_tpu_torch.config import V33Config
from splade_tpu_torch.models import modernbert
from splade_tpu_torch.models.hf_port import params_from_jax
from splade_tpu_torch.models.modernbert import (ModernBertConfig,
                                                ModernBertForMaskedLM)
from splade_tpu_torch.models.splade import SpladeEncoder
from splade_tpu_torch.ops import splash_attention as sa
from splade_tpu_torch.train.mlm import MLMConfig

# tiny shapes: more intra-op threads only contend with the other test
# workers for the host's cores
torch.set_num_threads(1)

VALUE_TOL = dict(rtol=0, atol=2e-6)
GRAD_TOL = dict(rtol=0, atol=5e-6)
MODEL_TOL = dict(atol=2e-5, rtol=1e-5)


def _case(seed, B, N, S, D, pack=4):
    """q, k, v [B, N, S, D], a seeded dO [B, S, N, D], and segment ids with
    padding: row 0 a plain row with a random length, row 1 ``pack`` packed
    segments each with its own length (the last one empty), the rest
    alternating; built by the port's own rule."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, N, S, D)).astype(np.float32)
               for _ in range(3))
    d_out = rng.normal(size=(B, S, N, D)).astype(np.float32)
    pos = np.arange(S)[None]
    mask = pos < rng.integers(S // 2, S + 1, (B, 1))
    segs = np.zeros((B, S), np.int64)
    width = -(-S // pack)
    for b in range(1, B, 2):
        segs[b] = pos[0] // width
        lens = rng.integers(1, width + 1, pack)
        lens[-1] = 0
        mask[b] = (pos[0] % width) < lens[segs[b]]
    seg = sa.segment_ids_with_padding(torch.from_numpy(mask.astype(np.int64)),
                                      torch.from_numpy(segs))
    return q, k, v, d_out, seg


def _port_out_and_grads(q, k, v, d_out, seg, half_window):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = sa.splash_attention(*leaves, seg, half_window)
    (out * torch.from_numpy(d_out)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


@pytest.fixture
def jax_splash_interpreted(monkeypatch):
    """JAX's splash kernel, forward and VJP, in Pallas interpret mode."""
    from jax.experimental.pallas.ops.tpu.splash_attention import (
        splash_attention_kernel)

    monkeypatch.setattr(
        splash_attention_kernel, "make_splash_mha",
        functools.partial(splash_attention_kernel.make_splash_mha,
                          interpret=True))
    return jax_modernbert._splash_attention


@pytest.mark.parametrize("S,N,half_window", [
    (128, 2, 4),    # a local layer: window, padding and packing together
    (128, 4, 0),    # a global layer
    (256, 2, 70),   # two of the port's 64-row tiles each side of the band
])
def test_plain_versions_match_jax_splash_kernel(jax_splash_interpreted, S, N,
                                                half_window):
    q, k, v, d_out, seg = _case(S + half_window, 2, N, S, 16)
    jseg = jnp.asarray(seg.numpy())

    def loss(q_, k_, v_):
        out = jax_splash_interpreted(q_, k_, v_, jseg, half_window)
        return jnp.sum(out * d_out), out

    (_, want), want_grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (q, k, v)))
    got, got_grads = _port_out_and_grads(q, k, v, d_out, seg, half_window)
    assert got.shape == (2, S, N, 16)  # JAX's layout: [B, S, N, D]
    np.testing.assert_allclose(got, np.asarray(want), **VALUE_TOL)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)


def _dense_reference(q, k, v, seg, half_window):
    """Masked softmax attention with the [B, N, S, S] scores written out."""
    S, D = q.shape[2], q.shape[3]
    ok = seg[:, :, None] == seg[:, None, :]
    if half_window:
        idx = torch.arange(S)
        ok = ok & ((idx[:, None] - idx[None, :]).abs() <= half_window)
    s = (q @ k.transpose(-1, -2)) / math.sqrt(D)
    s = s.masked_fill(~ok[:, None], float("-inf"))
    return (torch.softmax(s, -1) @ v).transpose(1, 2), torch.logsumexp(s, -1)


@pytest.mark.parametrize("S", [37, 100, 200])  # not multiples of the 64 tile
@pytest.mark.parametrize("half_window", [4, 0])
def test_plain_versions_match_dense_softmax_at_ragged_lengths(S, half_window):
    q, k, v, d_out, seg = _case(S, 3, 2, S, 16)
    got, got_grads = _port_out_and_grads(q, k, v, d_out, seg, half_window)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    want, want_lse = _dense_reference(*leaves, seg, half_window)
    (want * torch.from_numpy(d_out)).sum().backward()
    np.testing.assert_allclose(got, want.detach().numpy(), **VALUE_TOL)
    for g, t in zip(got_grads, leaves):
        np.testing.assert_allclose(g, t.grad.numpy(), **GRAD_TOL)
    _, lse = sa.splash_attention_forward(*(t.detach() for t in leaves), seg,
                                         half_window)
    assert lse.shape == (3, 2, S) and bool(torch.isfinite(lse).all())
    np.testing.assert_allclose(lse.numpy(), want_lse.detach().numpy(),
                               **GRAD_TOL)


def test_backward_wrappers_are_the_plain_backward_on_the_cpu():
    q, k, v, d_out, seg = (torch.from_numpy(x) if isinstance(x, np.ndarray)
                           else x for x in _case(5, 2, 2, 70, 16))
    out, lse = sa.splash_attention_forward(q, k, v, seg, 4)
    delta = sa.splash_attention_delta(d_out, out)
    assert delta.shape == lse.shape == (2, 2, 70)
    dq, dk, dv = sa.splash_attention_bwd_plain(q, k, v, seg, 4, d_out, lse,
                                               delta)
    # the dq wrapper takes out and returns the delta it computed
    got_dq, got_delta = sa.splash_attention_bwd_dq(q, k, v, seg, 4, d_out,
                                                   out, lse)
    assert torch.equal(got_dq, dq) and torch.equal(got_delta, delta)
    none, delta_only = sa.splash_attention_bwd_dq(q, k, v, seg, 4, d_out,
                                                  out, lse, None)
    assert none is None and torch.equal(delta_only, delta)
    got_dk, got_dv = sa.splash_attention_bwd_dkv(q, k, v, seg, 4, d_out, lse,
                                                 delta)
    assert torch.equal(got_dk, dk) and torch.equal(got_dv, dv)
    assert dq.shape == (2, 70, 2, 16)
    # gradients in the dtypes asked: the f32 ones cast
    bf = torch.bfloat16
    assert torch.equal(sa.splash_attention_bwd_dq(q, k, v, seg, 4, d_out,
                                                  out, lse, bf)[0], dq.to(bf))
    got_dk, got_dv = sa.splash_attention_bwd_dkv(q, k, v, seg, 4, d_out, lse,
                                                 delta, torch.float32, bf)
    assert torch.equal(got_dk, dk) and torch.equal(got_dv, dv.to(bf))


def test_tile_range_skips_tiles_outside_the_band():
    assert list(sa.tile_range(0, 512, 0)) == list(range(8))
    assert list(sa.tile_range(0, 512, 64)) == [0, 1]
    assert list(sa.tile_range(256, 512, 64)) == [3, 4, 5]
    assert list(sa.tile_range(448, 512, 64)) == [6, 7]
    assert list(sa.tile_range(192, 200, 4)) == [2, 3]   # the ragged last tile
    assert list(sa.tile_range(64, 200, 1)) == [0, 1, 2]


def test_segment_ids_with_padding_rule():
    mask = torch.tensor([[1, 1, 0, 0], [1, 0, 1, 0]])
    assert sa.segment_ids_with_padding(mask).tolist() == [
        [0, 0, 1_000_000, 1_000_000], [0, 1_000_000, 0, 1_000_000]]
    segs = torch.tensor([[0, 0, 1, 1], [2, 2, 3, 3]])
    got = sa.segment_ids_with_padding(mask, segs)
    assert got.dtype == torch.int32
    assert got.tolist() == [[0, 0, 1_000_001, 1_000_001],
                            [2, 1_000_002, 3, 1_000_003]]


# ---- (b) the whole model ---------------------------------------------------
def _toks(rng, n, length, vocab=512, pad_id=511):
    ids = rng.integers(3, vocab - 2, size=(n, length)).astype(np.int32)
    lengths = rng.integers(2, length + 1, size=(n,))
    mask = (np.arange(length)[None] < lengths[:, None]).astype(np.int32)
    return np.where(mask > 0, ids, pad_id), mask


def _t(*xs):
    return [torch.from_numpy(x.astype(np.int64)) for x in xs]


@pytest.fixture(scope="module")
def pair():
    """A JAX SPLADE model configured with attention_impl='splash' (sdpa's
    math off the TPU) and its parameters as numpy; local_attention=8."""
    jcfg = JaxConfig.tiny(local_attention=8, attention_impl="splash")
    jmodel = JaxSplade(jcfg, pool_impl="streamed", pool_tile=128)
    ids0 = jnp.zeros((1, 8), jnp.int32)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        jmodel.init(jax.random.PRNGKey(0), ids0, jnp.ones_like(ids0))["params"])
    rng = np.random.default_rng(0)
    params["mlm"]["decoder_bias"] = rng.normal(
        0, 0.3, params["mlm"]["decoder_bias"].shape).astype(np.float32)
    return jcfg, jmodel, params


def _port(params, attention_impl="splash", **over):
    cfg = ModernBertConfig.tiny(local_attention=8,
                                attention_impl=attention_impl, **over)
    model = SpladeEncoder(cfg, pool_impl="kernel", pool_tile=128, device="cpu")
    # a JAX parameter tree loads into a model on the splash route unchanged
    model.mlm.load_state_dict(params_from_jax(params))
    return model


@pytest.mark.parametrize("S", [24, 128])  # ragged, and JAX's own splash length
def test_encode_matches_jax_at_valid_positions(pair, S):
    jcfg, _, params = pair
    ids, mask = _toks(np.random.default_rng(S), 5, S)
    want = np.asarray(JaxMLM(jcfg).apply(
        {"params": params["mlm"]}, jnp.asarray(ids), jnp.asarray(mask),
        method="encode"))
    model = _port(params).mlm
    assert isinstance(model, ModernBertForMaskedLM)
    with torch.no_grad():
        got = model.encode(*_t(ids, mask)).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], **MODEL_TOL)


def test_padded_positions_differ_from_sdpa_and_are_finite(pair):
    _, _, params = pair
    ids, mask = _toks(np.random.default_rng(3), 6, 32)
    with torch.no_grad():
        splash = _port(params).mlm.encode(*_t(ids, mask))
        sdpa = _port(params, "sdpa").mlm.encode(*_t(ids, mask))
    valid = torch.from_numpy(mask.astype(bool))
    assert bool(torch.isfinite(splash).all())
    np.testing.assert_allclose(splash[valid].numpy(), sdpa[valid].numpy(),
                               **MODEL_TOL)
    # a padded query attends to the other padded tokens on the splash
    # route, to the valid ones on the sdpa route
    assert float((splash[~valid] - sdpa[~valid]).abs().max()) > 1e-2


@pytest.mark.parametrize("remat", [False, True])
def test_splade_forward_and_gradients_match_jax(pair, remat):
    _, jmodel, params = pair
    ids, mask = _toks(np.random.default_rng(4), 6, 32)

    def jax_loss(p):
        sparse, tw = jmodel.apply({"params": p}, jnp.asarray(ids),
                                  jnp.asarray(mask))
        return (sparse * sparse).sum(), (sparse, tw)

    (_, (want, want_tw)), grads = jax.value_and_grad(
        jax_loss, has_aux=True)(params)
    want_grads = params_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), grads))
    model = _port(params, remat=remat)
    sparse, tw = model(*_t(ids, mask))
    (sparse * sparse).sum().backward()
    np.testing.assert_allclose(sparse.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(want_tw), **MODEL_TOL)
    for name, p in model.mlm.named_parameters():
        scale = max(float(want_grads[name].abs().max()), 1.0)
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=0, atol=2e-5 * scale, err_msg=name)


@pytest.mark.parametrize("B", [8, 5])  # 5: the last packed row has empty slots
def test_packed_query_tower_matches_jax(pair, B):
    """forward_packed_qd hands the packed queries' segment ids and
    positions to the attention: values and gradients equal JAX's."""
    _, jmodel, params = pair
    rng = np.random.default_rng(20 + B)
    q_ids, q_mask = _toks(rng, B, 8)
    d_ids, d_mask = _toks(rng, 2 * B, 32)
    loss = lambda out: (out[0][0] * out[0][0]).sum() + abs(out[1][0]).sum()

    def jax_run(p):
        out = jmodel.apply({"params": p}, *map(jnp.asarray, (
            q_ids, q_mask, d_ids, d_mask)), method="forward_packed_qd")
        return loss(out), out

    (_, ((jq, _), (jd, _))), grads = jax.value_and_grad(
        jax_run, has_aux=True)(params)
    want_grads = params_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), grads))
    model = _port(params)
    out = model.forward_packed_qd(*_t(q_ids, q_mask, d_ids, d_mask))
    loss(out).backward()
    np.testing.assert_allclose(out[0][0].detach().numpy(), np.asarray(jq),
                               **MODEL_TOL)
    np.testing.assert_allclose(out[1][0].detach().numpy(), np.asarray(jd),
                               **MODEL_TOL)
    for name, p in model.mlm.named_parameters():
        scale = max(float(want_grads[name].abs().max()), 1.0)
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=0, atol=2e-5 * scale, err_msg=name)


def test_packed_queries_reach_the_attention_with_segments_and_positions(
        pair, monkeypatch):
    _, _, params = pair
    seen = []
    real = modernbert.splash_attention

    def recording(q, k, v, seg, half_window):
        seen.append((tuple(q.shape), seg.clone(), half_window))
        return real(q, k, v, seg, half_window)

    monkeypatch.setattr(modernbert, "splash_attention", recording)
    rng = np.random.default_rng(1)
    q_ids, q_mask = _toks(rng, 4, 8)
    d_ids, d_mask = _toks(rng, 2, 32)
    model = _port(params)
    with torch.no_grad():
        model.forward_packed_qd(*_t(q_ids, q_mask, d_ids, d_mask))
    cfg = model.config
    assert len(seen) == cfg.num_hidden_layers
    assert [hw for _, _, hw in seen] == [
        0 if cfg.is_global_layer(i) else cfg.local_attention // 2
        for i in range(cfg.num_hidden_layers)]
    shape, seg, _ = seen[0]
    assert shape == (3, cfg.num_attention_heads, 32, cfg.head_dim)
    # the packed row: segment j holds query j, padded tokens offset
    want = np.repeat(np.arange(4), 8) + 1_000_000 * (1 - q_mask.reshape(-1))
    assert seg[2].tolist() == want.tolist()
    assert seg[0].tolist() == (1_000_000 * (1 - d_mask[0])).tolist()


def test_sdpa_route_builds_biases_and_calls_no_splash(pair, monkeypatch):
    _, _, params = pair

    def refuse(*a, **k):
        raise AssertionError("the sdpa route reached the splash attention")

    monkeypatch.setattr(modernbert, "splash_attention", refuse)
    ids, mask = _toks(np.random.default_rng(2), 3, 16)
    with torch.no_grad():
        out, _ = _port(params, "sdpa")(*_t(ids, mask))
    assert bool(torch.isfinite(out).all())


# ---- (d) configuration -----------------------------------------------------
def test_attention_impl_round_trips_through_the_configs(monkeypatch):
    cfg = V33Config.from_dict({"model": {"attention_impl": "splash"}})
    assert cfg.model.attention_impl == "splash"
    assert V33Config.from_dict(cfg.to_dict()).model.attention_impl == "splash"
    assert V33Config().model.attention_impl == "sdpa"
    assert MLMConfig(attention_impl="splash").to_dict()[
        "attention_impl"] == "splash"
    monkeypatch.setenv("MLM_ATTENTION_IMPL", "splash")
    assert MLMConfig.load(None).attention_impl == "splash"
    hf = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
          "intermediate_size": 96, "vocab_size": 128,
          "attention_impl": "splash"}
    # a checkpoint's config.json does not choose the route, the caller does
    assert ModernBertConfig.from_hf_dict(hf).attention_impl == "sdpa"
    assert ModernBertConfig.from_hf_dict(
        hf, attention_impl="splash").attention_impl == "splash"
    assert (JaxConfig.from_hf_dict(hf).attention_impl
            == ModernBertConfig.from_hf_dict(hf).attention_impl)


@pytest.mark.parametrize("value", ["flash", "", "SPLASH"])
def test_an_unknown_attention_impl_raises(value):
    with pytest.raises(ValueError, match="attention_impl"):
        ModernBertConfig.tiny(attention_impl=value)
    with pytest.raises(ValueError, match="attention_impl"):
        dataclasses.replace(ModernBertConfig(), attention_impl=value)


def _count_splash_calls(monkeypatch):
    calls = []
    real = modernbert.splash_attention
    monkeypatch.setattr(
        modernbert, "splash_attention",
        lambda *a: calls.append(a[4]) or real(*a))
    return calls


def test_v33_yaml_attention_impl_reaches_the_model(tmp_path, monkeypatch):
    from test_data import FakeTokenizer

    from splade_tpu_torch.train import cli

    rng = np.random.default_rng(7)
    words = "검색 모델 한국어 문서 질의 벡터 학습 평가".split()
    text = lambda n: " ".join(rng.choice(words, n))
    data = tmp_path / "train_000.jsonl"
    data.write_text("\n".join(json.dumps(
        {"query": text(3), "positive": text(8), "negative": text(8)},
        ensure_ascii=False) for _ in range(16)))
    out = tmp_path / "run"
    (tmp_path / "cfg.yaml").write_text(
        f"model:\n  dtype: float32\n  remat: true\n"
        f"  attention_impl: splash\n"
        f"data:\n  train_files: ['{data}']\n  val_files: []\n"
        f"  batch_size: 2\n  query_max_length: 8\n  doc_max_length: 16\n"
        f"training:\n  num_epochs: 1\n  gradient_accumulation_steps: 2\n"
        f"  log_every_n_steps: 1\n  max_steps: 2\n  output_dir: {out}\n")

    class Tok(FakeTokenizer):
        def __len__(self):
            return 512

    monkeypatch.setattr(cli, "create_tokenizer", lambda *a, **k: Tok())
    tiny = ModernBertConfig.tiny
    monkeypatch.setattr(modernbert, "ModernBertConfig",
                        lambda **kw: tiny(num_hidden_layers=2, **kw))
    calls = _count_splash_calls(monkeypatch)
    assert cli.main(["--config", str(tmp_path / "cfg.yaml"), "--device",
                     "cpu"]) == 0
    resolved = json.loads((out / "resolved_config.json").read_text())
    assert resolved["model"]["attention_impl"] == "splash"
    # 2 steps x 2 micro-batches x 2 layers, forward and its recompute
    assert len(calls) == 2 * 2 * 2 * 2
    assert set(calls) == {0, 4}  # layer 0 global, layer 1 local (window 8)
    losses = [json.loads(line)["loss"] for line in
              (out / "metrics.jsonl").read_text().splitlines()]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_mlm_config_attention_impl_reaches_the_model(tmp_path, monkeypatch):
    import signal

    from test_torch_mlm import MLMFakeTokenizer, korean_ish_corpus

    from splade_tpu_torch.train import mlm
    from splade_tpu_torch.utils import tokenizer as tok_mod

    data = tmp_path / "corpus"
    data.mkdir()
    (data / "mlm_000.txt").write_text("\n".join(korean_ish_corpus(200)),
                                      "utf-8")
    monkeypatch.setattr(tok_mod, "create_tokenizer",
                        lambda path=None: MLMFakeTokenizer())
    tiny = ModernBertConfig.tiny
    monkeypatch.setattr(modernbert, "ModernBertConfig",
                        lambda **kw: tiny(num_hidden_layers=2, **kw))
    for name, value in {"MAX_LENGTH": "16", "GRAD_ACCUM": "2",
                        "LOGGING_STEPS": "1", "DTYPE": "float32",
                        "VAL_FRACTION": "0.0", "SAVE_STEPS": "0",
                        "EVAL_STEPS": "0",
                        "ATTENTION_IMPL": "splash"}.items():
        monkeypatch.setenv(f"MLM_{name}", value)
    calls = _count_splash_calls(monkeypatch)
    out = tmp_path / "out"
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    try:
        assert mlm.main(["--data-dir", str(data), "--output-dir", str(out),
                         "--epochs", "1", "--batch-size", "2", "--device",
                         "cpu", "--max-steps", "2"]) == 0
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    assert json.loads((out / "resolved_config.json").read_text())[
        "attention_impl"] == "splash"
    assert len(calls) == 2 * 2 * 2  # 2 steps x 2 micro-batches x 2 layers


# ---- (e) the launchers -----------------------------------------------------
class _RecordingLibrary:
    """Stands in for the built kernel library: every entry records its
    arguments and reports success, so the launchers can run on CPU tensors."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, args))
            return 0
        return call


def test_launchers_count_where_they_launch_and_nowhere_else(monkeypatch):
    """Each launcher adds one to its kernel's count after the C entry
    returned, never for an empty batch; the entries get the operands'
    strides as they are (the [B, N, S, D] views of [B, S, N, D] storage and
    of a fused QKV tensor are not copied), then B, N, S, D, the window and
    the scale. The backward hands the dq kernel the forward's out and an
    f32 delta buffer, which the dk/dv kernel then reads, and allocates each
    gradient in the dtype it asks the kernel to write (bf16 or f32)."""
    from splade_tpu_torch.ops import _cuda

    lib = _RecordingLibrary()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda t: 0)
    counted = dict(fwd=sa.splash_attention, dq=sa.splash_attention_bwd_dq,
                   dkv=sa.splash_attention_bwd_dkv)
    for fn in counted.values():
        monkeypatch.setattr(fn, "launches", 0)
    count = lambda: {k: fn.launches for k, fn in counted.items()}
    B, N, S, D = 3, 2, 40, 64
    g = torch.Generator().manual_seed(0)
    bf = lambda *shape: torch.randn(shape, generator=g).to(torch.bfloat16)
    q = bf(B, S, N, D).transpose(1, 2)
    k = bf(B, S, N, D).float().transpose(1, 2)   # cast to bf16 by the wrapper
    v = bf(B, S, 3, N, D)[:, :, 2].transpose(1, 2)
    seg = torch.zeros(B, S, dtype=torch.int64)
    d_out, out, lse = bf(B, S, N, D), bf(B, S, N, D), torch.zeros(B, N, S)

    out0, lse0 = sa._launch_fwd(q[:0], k[:0], v[:0], seg[:0], 4)
    dq0, delta0 = sa._launch_bwd_dq(q[:0], k[:0], v[:0], seg[:0], 4,
                                    d_out[:0], out[:0], lse[:0],
                                    torch.float32)
    dk0, dv0 = sa._launch_bwd_dkv(q[:0], k[:0], v[:0], seg[:0], 4, d_out[:0],
                                  lse[:0], lse[:0], torch.float32,
                                  torch.float32)
    assert lib.calls == [] and count() == dict(fwd=0, dq=0, dkv=0)
    assert out0.shape == dq0.shape == dk0.shape == dv0.shape == (0, S, N, D)
    assert lse0.shape == delta0.shape == (0, N, S)

    got_out, got_lse = sa._launch_fwd(q, k, v, seg, 4)
    assert count() == dict(fwd=1, dq=0, dkv=0)
    assert got_out.shape == (B, S, N, D) and got_out.dtype == torch.bfloat16
    assert got_lse.shape == (B, N, S) and got_lse.dtype == torch.float32
    dq, delta = sa._launch_bwd_dq(q, k, v, seg, 4, d_out, out, lse,
                                  torch.bfloat16)
    dk, dv = sa._launch_bwd_dkv(q, k, v, seg, 0, d_out, lse, delta,
                                torch.float32, torch.bfloat16)
    none, _ = sa._launch_bwd_dq(q, k, v, seg, 4, d_out, out, lse, None)
    assert count() == dict(fwd=1, dq=2, dkv=1)
    assert none is None
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16, torch.float32,
                                              torch.bfloat16)
    assert delta.shape == (B, N, S) and delta.dtype == torch.float32
    row, fused = S * N * D, S * 3 * N * D
    strides = (row, D, N * D, row, D, N * D, fused, D, 3 * N * D)
    scale = 1.0 / math.sqrt(D)
    # 9 pointers and 1 or 2 dtype flags (the forward: 6 pointers), then the
    # strides and integers, the scale, the stream
    assert [(entry, args[n_ptr:-1]) for (entry, args), n_ptr
            in zip(lib.calls, (6, 9, 9, 9))] == [
        ("splade_splash_attn_fwd", (*strides, B, N, S, D, 4, scale)),
        ("splade_splash_attn_bwd_dq", (1, *strides, B, N, S, D, 4, scale)),
        ("splade_splash_attn_bwd_dkv",
         (0, 1, *strides, B, N, S, D, 0, scale)),
        ("splade_splash_attn_bwd_dq", (0, *strides, B, N, S, D, 4, scale))]
    fwd_args, dq_args, dkv_args, none_args = (a for _, a in lib.calls)
    # q and v went in as they are: the first and third pointers are theirs
    assert fwd_args[0] == q.data_ptr() and fwd_args[2] == v.data_ptr()
    # dq: d_out, out, lse, then the delta and dq it writes; delta only: dq 0
    assert dq_args[4:9] == (d_out.data_ptr(), out.data_ptr(), lse.data_ptr(),
                            delta.data_ptr(), dq.data_ptr())
    assert none_args[8] == 0
    # dk/dv: d_out, lse and the dq kernel's delta, then dk and dv
    assert dkv_args[4:9] == (d_out.data_ptr(), lse.data_ptr(),
                             delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    # the signatures the loader declares have as many arguments as were passed
    for entry, args in lib.calls:
        assert len(_cuda.SIGNATURES[entry]) == len(args)


def test_function_backward_on_the_card_path_launches_dq_then_dkv(
        monkeypatch):
    """The autograd.Function's card path, on CPU tensors that claim to be
    CUDA ones: the dq wrapper first (with out, and a dtype for dq, or None
    when q needs no gradient), then the dk/dv wrapper fed the delta the dq
    wrapper returned, each gradient asked in its operand's dtype; no eager
    delta reduction."""
    calls = []
    fake_delta = torch.full((2, 2, 70), 7.0)

    def fake_dq(q, k, v, seg, hw, d_out, out, lse, dq_dtype):
        calls.append(("dq", out, dq_dtype))
        dq = None if dq_dtype is None else torch.ones(
            2, 70, 2, 16, dtype=dq_dtype)
        return dq, fake_delta

    def fake_dkv(q, k, v, seg, hw, d_out, lse, delta, dk_dtype, dv_dtype):
        calls.append(("dkv", delta, dk_dtype, dv_dtype))
        return (torch.full((2, 70, 2, 16), 2.0, dtype=dk_dtype),
                torch.full((2, 70, 2, 16), 3.0, dtype=dv_dtype))

    def no_delta(*a):
        raise AssertionError("the card path reduced delta eagerly")

    monkeypatch.setattr(sa, "splash_attention_bwd_dq", fake_dq)
    monkeypatch.setattr(sa, "splash_attention_bwd_dkv", fake_dkv)
    monkeypatch.setattr(sa, "splash_attention_delta", no_delta)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    q, k, v, d_out, seg = (torch.from_numpy(x) if isinstance(x, np.ndarray)
                           else x for x in _case(7, 2, 2, 70, 16))
    out, lse = torch.zeros(2, 70, 2, 16, dtype=torch.bfloat16), torch.zeros(
        2, 2, 70)
    for need_q in (True, False):
        calls.clear()
        ctx = type("Ctx", (), {})()
        ctx.saved_tensors = (q, k, v, seg, out, lse)
        ctx.half_window = 4
        ctx.dtypes = (torch.float32, torch.float32, torch.bfloat16)
        ctx.needs_input_grad = (need_q, True, True, False, False)
        grads = sa._SplashAttention.backward.__wrapped__(ctx, d_out)
        assert [c[0] for c in calls] == ["dq", "dkv"]
        assert calls[0][1] is out
        assert calls[0][2] == (torch.float32 if need_q else None)
        assert calls[1][1] is fake_delta
        assert calls[1][2:] == (torch.float32, torch.bfloat16)
        assert (grads[0] is None) == (not need_q)
        assert grads[1].dtype == torch.float32 and bool((grads[1] == 2).all())
        assert grads[2].dtype == torch.bfloat16 and bool((grads[2] == 3).all())
        assert grads[1].shape == (2, 2, 70, 16)  # back to [B, N, S, D]
        assert grads[3:] == (None, None)


def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    from splade_tpu_torch.ops import _cuda

    monkeypatch.setattr(_cuda, "library", _RecordingLibrary)
    q = torch.zeros(2, 2, 8, 16, dtype=torch.bfloat16)
    seg = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="head dim 16"):
        sa._launch_fwd(q, q, q, seg, 0)
    q64 = torch.zeros(2, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="k .* must be"):
        sa._launch_fwd(q64, q64[:, :1], q64, seg, 0)
    with pytest.raises(ValueError, match="seg"):
        sa._launch_fwd(q64, q64, q64, seg[:, :4], 0)
    d_out = torch.zeros(2, 8, 2, 64)
    with pytest.raises(ValueError, match="dO"):
        sa._launch_bwd_dq(q64, q64, q64, seg, 0, q64, d_out,
                          torch.zeros(2, 2, 8), torch.float32)
    with pytest.raises(ValueError, match="out"):
        sa._launch_bwd_dq(q64, q64, q64, seg, 0, d_out, q64,
                          torch.zeros(2, 2, 8), torch.float32)
    with pytest.raises(ValueError, match="delta"):
        sa._launch_bwd_dkv(q64, q64, q64, seg, 0, d_out, torch.zeros(2, 2, 8),
                           torch.zeros(2, 8), torch.float32, torch.float32)
