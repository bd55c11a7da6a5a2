"""The port's V33 training (splade_tpu_torch.train, .losses, .config, .data)
against splade_tpu's on the same numpy inputs, on the CPU in f32.

JAX runs its step on a 1-device mesh (num_blocks 1, as the port on one GPU)
with the Pallas pool in interpret mode or the streamed pool; the port runs
its kernel route, whose wrappers take their plain versions on CPU tensors.
Tolerances: only the order of f32 sums differs, so losses and grad norms
agree to 1e-5 relative and gradients to 1e-4 of each tensor's largest
value; AdamW updates are then compared after the schedule's lr-0 first
step."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from splade_tpu.config.v33 import V33Config as JaxV33Config
from splade_tpu.data.collator import TripletCollator as JaxCollator
from splade_tpu.data.loader import load_training_data as jax_load
from splade_tpu.data.pipeline import create_dataloader as jax_dataloader
from splade_tpu.models.modernbert import ModernBertConfig as JaxMBConfig
from splade_tpu.models.splade import SpladeEncoder as JaxSplade
from splade_tpu.parallel.mesh import make_mesh
from splade_tpu.train.state import create_train_state as jax_train_state
from splade_tpu.train.state import decay_mask as jax_decay_mask
from splade_tpu.train.trainer import Trainer as JaxTrainer
from splade_tpu.train.trainer import make_loss_fn as jax_make_loss_fn
from splade_tpu.train.trainer import make_train_step as jax_make_train_step
from splade_tpu.train.trainer import stack_microbatches as jax_stack
from splade_tpu_torch.config import V33Config, load_config
from splade_tpu_torch.data.collator import TripletCollator
from splade_tpu_torch.data.loader import load_training_data
from splade_tpu_torch.data.pipeline import create_dataloader
from splade_tpu_torch.models.hf_port import params_from_jax
from splade_tpu_torch.models.modernbert import ModernBertConfig
from splade_tpu_torch.models.splade import SpladeEncoder
from splade_tpu_torch.train import checkpoint as ckpt
from splade_tpu_torch.train.state import (create_train_state, decays,
                                          warmup_cosine_schedule)
from splade_tpu_torch.train.trainer import (DevicePrefetcher, Trainer,
                                            make_loss_fn, make_train_step,
                                            pin_batch, stack_microbatches,
                                            to_device)

from test_data import FakeTokenizer

# tiny shapes: more intra-op threads only contend with the other test
# workers for the host's cores
torch.set_num_threads(1)

VOCAB = 512
LAYERS = 2
CFG = {
    "model": {"dtype": "float32"},
    "mesh": {"num_data": 1},
    "loss": {"flops_warmup_steps": 10},
    "training": {"gradient_accumulation_steps": 2, "learning_rate": 1e-3},
}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module")
def jax_params():
    """A tiny JAX SpladeEncoder's parameters (numpy), with a non-zero
    decoder bias so its gradient path shows."""
    model = JaxSplade(JaxMBConfig.tiny(num_hidden_layers=LAYERS),
                      pool_impl="streamed", pool_tile=128)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = _numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(0), ids,
                                             jnp.ones_like(ids))["params"])
    rng = np.random.default_rng(0)
    params["mlm"]["decoder_bias"] = rng.normal(
        0, 0.3, params["mlm"]["decoder_bias"].shape).astype(np.float32)
    return params


def port_model(params, pool_impl="kernel", remat=False):
    model = SpladeEncoder(ModernBertConfig.tiny(num_hidden_layers=LAYERS,
                                                remat=remat),
                          pool_impl=pool_impl, pool_tile=128,
                          with_token_weights=False, device="cpu")
    model.mlm.load_state_dict(params_from_jax(params))
    return model


def jax_model(pool_impl):
    return JaxSplade(JaxMBConfig.tiny(num_hidden_layers=LAYERS),
                     pool_impl=pool_impl, pool_tile=128, pallas_tile_v=128)


def synth_micro(rng, B=8, k=1, Lq=8, Ld=32, teacher=False):
    def tok(n, L):
        ids = rng.integers(3, VOCAB - 2, size=(n, L)).astype(np.int32)
        lengths = rng.integers(2, L + 1, size=(n,))
        mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
        return np.where(mask > 0, ids, VOCAB - 1), mask

    qi, qm = tok(B, Lq)
    pi, pm = tok(B, Ld)
    ni, nm = tok(B * k, Ld)
    mb = {"query_input_ids": qi, "query_attention_mask": qm,
          "positive_input_ids": pi, "positive_attention_mask": pm,
          "negative_input_ids": ni, "negative_attention_mask": nm}
    if teacher:
        mb["teacher_pos_scores"] = rng.normal(size=(B,)).astype(np.float32)
        mb["teacher_neg_scores"] = rng.normal(size=(B, k)).astype(np.float32)
    return mb


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _port_grads(model):
    return {n: p.grad.clone() for n, p in model.mlm.named_parameters()}


def _close_to_max(got, want, rtol):
    """every element within rtol of the tensor's largest magnitude"""
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("k", [1, 3])
def test_loss_and_grads_match_jax(jax_params, packed, k):
    """make_loss_fn's loss and every parameter's gradient against JAX's,
    packed query tower and not, one and three hard negatives."""
    micro = synth_micro(np.random.default_rng(3 + k), B=6, k=k)
    jcfg = JaxV33Config()
    jfn = jax_make_loss_fn(jax_model("pallas"), jcfg.loss, 1,
                           packed_query=packed)
    (jloss, jmet), jgrads = jax.value_and_grad(jfn, has_aux=True)(
        jax_params, {k_: jnp.asarray(v) for k_, v in micro.items()},
        jnp.int32(10))
    model = port_model(jax_params)
    tloss, tmet = make_loss_fn(model, V33Config().loss, 1,
                               packed_query=packed)(_t(micro), 10)
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for name, v in tmet.as_dict().items():
        np.testing.assert_allclose(float(v), float(getattr(jmet, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    want = params_from_jax(_numpy_tree(jgrads))
    for name, g in _port_grads(model).items():
        _close_to_max(g.numpy(), want[name].numpy(), 1e-4)


# -------------------------------------------------------------- optimizer
def test_optimizer_matches_optax_chain():
    """The same numpy gradients through optax's clip + AdamW(mask) +
    warmup-cosine and through the port's: parameters within 1e-6 over 5
    steps (the first at learning rate 0)."""
    rng = np.random.default_rng(5)
    shapes = {"model.layers.0.attn.Wqkv.weight": (12, 4),
              "model.layers.0.mlp_norm.weight": (4,),
              "decoder.bias": (7,)}
    init = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (rng.normal(size=s) * (3.0 if i % 2 else 0.1)).astype(
        np.float32) for n, s in shapes.items()} for i in range(5)]

    class Params(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for n, v in init.items():
                self.register_parameter(n.replace(".", "__"),
                                        torch.nn.Parameter(torch.tensor(v)))

        def named_parameters(self, *a, **k):
            for n, p in super().named_parameters(*a, **k):
                yield n.replace("__", "."), p

    tcfg = V33Config().training
    tcfg.learning_rate, tcfg.weight_decay = 1e-2, 0.1
    module = Params()
    state = create_train_state(module, tcfg, total_steps=8)
    jcfg = JaxV33Config().training
    jcfg.learning_rate, jcfg.weight_decay = 1e-2, 0.1
    # flax-style keys so JAX's decay_mask applies its own rule
    jtree = {"w": {"kernel": init["model.layers.0.attn.Wqkv.weight"]},
             "n": {"scale": init["model.layers.0.mlp_norm.weight"]},
             "decoder_bias": init["decoder.bias"]}
    jstate = jax_train_state(jax.tree_util.tree_map(jnp.asarray, jtree),
                             jcfg, total_steps=8)
    params, opt = jstate.params, jstate.opt_state
    named = dict(module.named_parameters())
    for g in grads:
        jg = {"w": {"kernel": g["model.layers.0.attn.Wqkv.weight"]},
              "n": {"scale": g["model.layers.0.mlp_norm.weight"]},
              "decoder_bias": g["decoder.bias"]}
        upd, opt = jstate.tx.update(jax.tree_util.tree_map(jnp.asarray, jg),
                                    opt, params)
        params = optax.apply_updates(params, upd)
        for n, p in named.items():
            p.grad = torch.tensor(g[n])
        torch.nn.utils.clip_grad_norm_(list(named.values()), tcfg.gradient_clip)
        state.optimizer.step()
        state.scheduler.step()
    for n, jv in (("model.layers.0.attn.Wqkv.weight", params["w"]["kernel"]),
                  ("model.layers.0.mlp_norm.weight", params["n"]["scale"]),
                  ("decoder.bias", params["decoder_bias"])):
        np.testing.assert_allclose(named[n].detach().numpy(), np.asarray(jv),
                                   rtol=0, atol=1e-6, err_msg=n)
    assert not np.allclose(named["decoder.bias"].detach().numpy(),
                           init["decoder.bias"])


@pytest.mark.parametrize("total,ratio", [(10, 0.06), (100, 0.06), (7, 0.5)])
def test_schedule_matches_optax(total, ratio):
    from splade_tpu.train.state import warmup_cosine_schedule as jax_sched

    want = jax_sched(3e-4, total, ratio)
    got = warmup_cosine_schedule(3e-4, total, ratio)
    for step in range(total + 3):  # optax evaluates in f32: 1e-5 relative
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5,
                                   atol=1e-12)
    assert got(0) == 0.0


def test_decay_rule_matches_jax_mask(jax_params):
    """The same elements decay: all but LayerNorm weights and biases."""
    leaves = jax.tree_util.tree_leaves(jax_params)
    on = jax.tree_util.tree_leaves(jax_decay_mask(jax_params))
    n_jax = sum(int(np.size(x)) for x, d in zip(leaves, on) if d)
    model = port_model(jax_params)
    assert n_jax == sum(p.numel() for n, p in model.named_parameters()
                        if decays(n))
    assert not decays("mlm.decoder.bias")
    assert not decays("mlm.model.layers.1.attn_norm.weight")
    assert decays("mlm.model.embeddings.tok_embeddings.weight")


# -------------------------------------------------------------- train step
@pytest.mark.parametrize("jax_pool", ["pallas", "streamed"])
def test_train_step_matches_jax(jax_params, jax_pool):
    """3 optimizer steps of accum 2 on one batch: loss and grad_norm per
    step to 1e-5. Parameters after step 3 (two updates after the lr-0
    first one): 99.9% of each tensor's elements within 1e-5, all within
    2·lr. Adam divides by sqrt(v) + 1e-8, so where a gradient is near 0
    (embedding rows of absent tokens) its last bits can move an update by
    up to lr; elsewhere updates agree to f32 rounding."""
    rng = np.random.default_rng(11)
    host = jax_stack([synth_micro(rng) for _ in range(2)])
    vcfg = dict(CFG, training=dict(CFG["training"], max_steps=0))
    jcfg = JaxV33Config.from_dict(vcfg)
    jmodel = jax_model(jax_pool)
    jstate = jax_train_state(jax.tree_util.tree_map(jnp.array, jax_params),
                             jcfg.training, total_steps=10)
    step_fn = jax_make_train_step(jmodel, jcfg, make_mesh(num_data=1),
                                  jstate.tx)
    p, o, s = jstate.params, jstate.opt_state, jstate.step
    jax_metrics = []
    for _ in range(3):
        p, o, s, m = step_fn(p, o, s, host)
        jax_metrics.append({k: float(v) for k, v in m.items()})

    cfg = V33Config.from_dict(vcfg)
    model = port_model(jax_params)
    state = create_train_state(model, cfg.training, total_steps=10)
    tstep = make_train_step(cfg)
    for i in range(3):
        m = tstep(state, _t(host))
        for k in ("loss", "grad_norm", "infonce", "flops_q", "lambda_q"):
            np.testing.assert_allclose(float(m[k]), jax_metrics[i][k],
                                       rtol=1e-5, err_msg=f"step {i}: {k}")
    assert state.step == 3
    want = params_from_jax(_numpy_tree(p))
    lr = cfg.training.learning_rate
    for name, t in model.mlm.named_parameters():
        diff = (t.detach() - want[name]).abs()
        assert float((diff <= 1e-5).float().mean()) >= 0.999, name
        assert float(diff.max()) <= 2 * lr, name
    init = params_from_jax(jax_params)
    moved = max(float((t.detach() - init[n]).abs().max())
                for n, t in model.mlm.named_parameters())
    assert moved > 1e-4  # the compared steps did update


def test_train_step_with_teacher_and_remat_matches_plain(jax_params):
    """MarginMSE + three negatives; layer recompute gives the same step."""
    rng = np.random.default_rng(12)
    host = stack_microbatches([synth_micro(rng, k=3, teacher=True)
                               for _ in range(2)])
    cfg = V33Config.from_dict(dict(CFG, loss={"lambda_margin_mse": 0.3,
                                              "flops_warmup_steps": 10}))
    out = []
    for remat in (False, True):
        model = port_model(jax_params, remat=remat)
        state = create_train_state(model, cfg.training, total_steps=10)
        m = make_train_step(cfg)(state, _t(host))
        out.append((m, {n: p.detach().clone()
                        for n, p in model.named_parameters()}))
    assert float(out[0][0]["margin_mse"]) > 0
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(out[1][0][k]), float(out[0][0][k]),
                                   rtol=1e-6)


def test_repeated_step_is_bitwise_identical(jax_params):
    rng = np.random.default_rng(9)
    host = stack_microbatches([synth_micro(rng) for _ in range(2)])
    cfg = V33Config.from_dict(CFG)
    runs = []
    for _ in range(2):
        model = port_model(jax_params)
        state = create_train_state(model, cfg.training, total_steps=10)
        step = make_train_step(cfg)
        for _ in range(2):
            m = step(state, _t(host))
        runs.append((float(m["loss"]), [p.detach().clone()
                                         for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_train_step_refuses_a_wrong_accumulation(jax_params):
    cfg = V33Config.from_dict(CFG)
    state = create_train_state(port_model(jax_params), cfg.training, 10)
    host = stack_microbatches([synth_micro(np.random.default_rng(0))])
    with pytest.raises(ValueError, match="micro-batches"):
        make_train_step(cfg)(state, _t(host))


# ----------------------------------------------------------------- trainer
def _samples(n=64, seed=7):
    rng = np.random.default_rng(seed)
    words = ["검색", "모델", "한국어", "문서", "질의", "벡터"]
    mk = lambda: " ".join(rng.choice(words, size=4))
    return [{"query": mk(), "positive": mk(), "negative": mk()}
            for _ in range(n)]


def _trainer_cfg(out, epochs=2, batch=2, **training):
    t = {"num_epochs": epochs, "gradient_accumulation_steps": 2,
         "log_every_n_steps": 1, "save_every_n_epochs": 2,
         "eval_every_n_epochs": 100, "learning_rate": 1e-3,
         "output_dir": str(out)}
    t.update(training)
    return {"model": {"dtype": "float32"}, "mesh": {"num_data": 1},
            "data": {"batch_size": batch, "query_max_length": 8,
                     "doc_max_length": 16},
            "training": t}


def _port_trainer(params, out, epochs=2, batch=2, **training):
    cfg = V33Config.from_dict(_trainer_cfg(out, epochs, batch, **training))
    col = TripletCollator(FakeTokenizer(), query_max_length=8,
                          doc_max_length=16)
    return Trainer(cfg, port_model(params), _samples(), col, device="cpu")


def _losses(out):
    return [json.loads(line)["loss"]
            for line in (out / "metrics.jsonl").read_text().splitlines()]


def test_trainer_logs_the_same_losses_as_jax(jax_params, tmp_path):
    """Both Trainers on the same 64 triplets and FakeTokenizer, one device
    (num_blocks 1): the same order of batches and the same first losses."""
    jcfg = JaxV33Config.from_dict(_trainer_cfg(tmp_path / "jax", epochs=1,
                                               max_steps=3))
    jcol = JaxCollator(FakeTokenizer(), query_max_length=8, doc_max_length=16)
    JaxTrainer(jcfg, jax_model("streamed"),
               jax.tree_util.tree_map(jnp.array, jax_params), _samples(),
               jcol).train()
    tr = _port_trainer(jax_params, tmp_path / "port", epochs=1, max_steps=3)
    state = tr.train()
    assert state.step == 3
    want, got = _losses(tmp_path / "jax"), _losses(tmp_path / "port")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert ckpt.find_latest_checkpoint(str(tmp_path / "port"))


def test_mid_epoch_resume_is_bitwise_exact(jax_params, tmp_path):
    # 64 triplets in batches of 8, accum 2: 4 steps an epoch; max_steps is
    # set after construction, so all three share the 8-step schedule
    full = _port_trainer(jax_params, tmp_path / "a", batch=8)
    assert full.steps_per_epoch == 4 and full.total_steps == 8
    full.cfg.training.max_steps = 6
    full_state = full.train()
    assert full_state.step == 6

    half = _port_trainer(jax_params, tmp_path / "b", batch=8)
    half.cfg.training.max_steps = 3
    path = ckpt.save_checkpoint(str(tmp_path / "b"), half.train(), epoch=1)
    res = _port_trainer(jax_params, tmp_path / "c", batch=8)
    res.state, meta = ckpt.load_checkpoint(path, res.state)
    assert meta["full_resume"] and res.state.step == 3
    res.start_epoch = min(res.state.step // res.steps_per_epoch + 1, 2)
    assert res.start_epoch == 1  # resumes INSIDE epoch 1
    res.cfg.training.max_steps = 6
    assert res.train().step == 6
    for a, b in zip(full_state.model.parameters(), res.model.parameters()):
        assert torch.equal(a, b)


def test_model_only_checkpoint_and_incomplete_dirs(jax_params, tmp_path):
    tr = _port_trainer(jax_params, tmp_path / "run", epochs=1)
    final = ckpt.save_final_model(str(tmp_path), tr.model)
    fresh = _port_trainer(jax_params, tmp_path / "run2", epochs=1)
    with torch.no_grad():
        for p in fresh.model.parameters():
            p.add_(1.0)
    fresh.state, meta = ckpt.load_checkpoint(final, fresh.state)
    assert meta["full_resume"] is False and fresh.state.step == 0
    for a, b in zip(tr.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)
    good = ckpt.save_checkpoint(str(tmp_path), tr.state, epoch=1)
    bad = tmp_path / "checkpoint_epoch9_step99"
    bad.mkdir()
    (bad / ckpt.MODEL_FILE).write_bytes(b"partial")
    assert ckpt.find_latest_checkpoint(str(tmp_path)) == good
    assert not list(tmp_path.glob("**/*.tmp"))  # atomic renames


def test_trainer_refuses_what_it_does_not_port(jax_params, tmp_path):
    def make(training, mesh):
        d = _trainer_cfg(tmp_path, 1, **training)
        d["mesh"].update(mesh)
        return Trainer(V33Config.from_dict(d), port_model(jax_params),
                       _samples(), TripletCollator(FakeTokenizer()),
                       device="cpu")

    # without a process group the world is one rank: 2 is not its size
    with pytest.raises(ValueError, match="not the world size 1"):
        make({}, {"num_data": 2})
    # the hang watchdog is ported: a window above 0 is taken, and armed
    # only by train() (tests/test_torch_preemption.py runs it)
    trainer = make({"watchdog_timeout_s": 5.0}, {})
    assert trainer.cfg.training.watchdog_timeout_s == 5.0
    assert trainer._watchdog is None and not trainer._preempted


def test_trainer_eval_and_depth_zero(jax_params, tmp_path):
    from splade_tpu.train.eval import MidTrainingEvaluator as JaxEvaluator
    from splade_tpu_torch.train.eval import MidTrainingEvaluator

    col = TripletCollator(FakeTokenizer(), query_max_length=8,
                          doc_max_length=16)
    ev = MidTrainingEvaluator(_samples(32, seed=1), col, batch_size=8)
    cfg = V33Config.from_dict(_trainer_cfg(
        tmp_path, 1, eval_every_n_epochs=1))
    cfg.data.device_prefetch_depth = 0
    tr = Trainer(cfg, port_model(jax_params), _samples(), col, evaluator=ev,
                 device="cpu")
    tr.train()
    scores = tr.evaluate()
    jev = JaxEvaluator(_samples(32, seed=1), JaxCollator(
        FakeTokenizer(), query_max_length=8, doc_max_length=16), batch_size=8)
    assert ev.queries == jev.queries and ev.docs == jev.docs
    assert 0 < scores["mrr"] <= 1 and scores["num_queries"] == len(ev.queries)


# --------------------------------------------------------------------- CLI
def test_cli_trains_a_tiny_config(tmp_path, monkeypatch):
    import splade_tpu_torch.models.modernbert as mb
    from splade_tpu_torch.train import cli

    data = tmp_path / "train_000.jsonl"
    data.write_text("\n".join(json.dumps(s, ensure_ascii=False)
                              for s in _samples(32)))
    out = tmp_path / "run"
    (tmp_path / "cfg.yaml").write_text(
        f"model:\n  dtype: float32\n  remat: true\n"
        f"data:\n  train_files: ['{data}']\n  val_files: ['{data}']\n"
        f"  batch_size: 2\n  query_max_length: 8\n  doc_max_length: 16\n"
        f"training:\n  num_epochs: 1\n  gradient_accumulation_steps: 2\n"
        f"  log_every_n_steps: 1\n  eval_every_n_epochs: 1\n"
        f"  output_dir: {out}\n")

    class Tok(FakeTokenizer):
        def __len__(self):
            return VOCAB

    monkeypatch.setattr(cli, "create_tokenizer", lambda *a, **k: Tok())
    tiny = ModernBertConfig.tiny
    monkeypatch.setattr(mb, "ModernBertConfig",
                        lambda **kw: tiny(num_hidden_layers=1, **kw))
    monkeypatch.setenv("TRAIN_TRAINING__MAX_STEPS", "3")
    assert cli.main(["--config", str(tmp_path / "cfg.yaml"), "--device",
                     "cpu", "--lr", "1e-3"]) == 0
    assert len(_losses(out)) == 3
    resolved = json.loads((out / "resolved_config.json").read_text())
    assert resolved["training"]["max_steps"] == 3
    assert resolved["training"]["learning_rate"] == 1e-3
    assert (out / "final_model" / ckpt.MODEL_FILE).exists()
    # --resume picks the checkpoint up and trains on to the new cap
    monkeypatch.setenv("TRAIN_TRAINING__MAX_STEPS", "5")
    assert cli.main(["--config", str(tmp_path / "cfg.yaml"), "--device",
                     "cpu", "--resume"]) == 0
    assert len(_losses(out)) == 5


def test_config_loader_matches_jax(tmp_path):
    from splade_tpu.config.loader import load_config as jax_load_config

    env = {"TRAIN_TRAINING__LEARNING_RATE": "2e-5",
           "TRAIN_DATA__BATCH_SIZE": "16", "TRAIN_MODEL__REMAT": "false",
           "TRAIN_NOPE__X": "1", "IGNORED": "1"}
    path = "configs/train_v33.yaml"
    got = load_config(path, overrides={"loss": {"lambda_q": 0.5}},
                      environ=env).to_dict()
    want = jax_load_config(path, overrides={"loss": {"lambda_q": 0.5}},
                           environ=env).to_dict()
    assert got == want
    assert got["training"]["learning_rate"] == 2e-5
    assert got["model"]["remat"] is False


# -------------------------------------------------------------------- data
def test_collator_and_loader_match_jax(tmp_path):
    rows = [{"query": f"질의 {i}", "positive": f"문서 {i} 검색",
             "negatives": [f"음성 {i}", f"다른 {i}"][: 1 + i % 2],
             "teacher_pos_score": 0.5 + i, "teacher_neg_scores": [0.1]}
            for i in range(10)]
    (tmp_path / "train_000.jsonl").write_text(
        "\n".join(json.dumps(r, ensure_ascii=False) for r in rows) + "\nbad\n")
    pattern = str(tmp_path / "train_*.jsonl")
    got, want = load_training_data(pattern), jax_load(pattern)
    assert got.samples == want.samples
    for kw in ({}, {"length_buckets": (0.5, 1.0)}):
        col = TripletCollator(FakeTokenizer(), query_max_length=8,
                              doc_max_length=16, num_hard_negatives=2, **kw)
        jcol = JaxCollator(FakeTokenizer(), query_max_length=8,
                           doc_max_length=16, num_hard_negatives=2, **kw)
        a = create_dataloader(got, col, 4, seed=3, process_index=0,
                              process_count=1)
        b = jax_dataloader(want, jcol, 4, seed=3, process_index=0,
                           process_count=1)
        a.set_epoch(2)
        b.set_epoch(2)
        batches = list(zip(a, b))
        assert len(batches) == len(b) == 2
        for x, y in batches:
            assert x.keys() == y.keys()
            for k in x:
                if isinstance(x[k], np.ndarray):
                    np.testing.assert_array_equal(x[k], y[k])
                else:
                    assert x[k] == y[k]


def test_dataloader_takes_its_rank_from_torch_distributed():
    loader = create_dataloader(list(range(10)), lambda b: b, 2)
    assert (loader.process_index, loader.process_count) == (0, 1)


# ------------------------------------------------------- device prefetcher
class TestDevicePrefetcher:
    def test_order_and_transfer_applied(self):
        seen = []
        pf = DevicePrefetcher(iter(range(10)),
                              lambda x: (seen.append(x), x * 2)[1], depth=2)
        assert list(pf) == [x * 2 for x in range(10)]
        assert seen == list(range(10))

    def test_errors_propagate(self):
        def gen():
            yield 1
            raise RuntimeError("boom")

        it = iter(DevicePrefetcher(gen(), lambda x: x, depth=2))
        assert next(it) == 1
        with pytest.raises(RuntimeError, match="boom"):
            next(it)

        def bad(x):
            raise ValueError("transfer failed")

        with pytest.raises(ValueError, match="transfer failed"):
            list(DevicePrefetcher(iter([1]), bad, depth=2))

    def test_early_close_unblocks_worker_and_closes_source(self):
        closed = []

        def src():
            try:
                i = 0
                while True:
                    yield i
                    i += 1
            finally:
                closed.append(True)

        pf = DevicePrefetcher(src(), lambda x: x, depth=2)
        assert next(iter(pf)) == 0
        pf.close()
        assert not pf._thread.is_alive() and closed

    def test_pin_and_copy_keep_values(self):
        host = stack_microbatches([synth_micro(np.random.default_rng(1))
                                   for _ in range(2)])
        dev = to_device(pin_batch(host, pin=False), torch.device("cpu"))
        for k, v in host.items():
            np.testing.assert_array_equal(dev[k].numpy(), v)


def test_stack_microbatches_matches_jax():
    rng = np.random.default_rng(2)
    micro = [synth_micro(rng, Ld=12), synth_micro(rng, Ld=16, teacher=True)]
    got, want = stack_microbatches(micro), jax_stack(micro)
    assert got.keys() == want.keys()
    assert "teacher_pos_scores" not in got  # present in one micro only
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
