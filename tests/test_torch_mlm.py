"""The port's MLM pre-training tier (splade_tpu_torch.train.mlm) against
splade_tpu's on the same numpy inputs, on the CPU in f32.

``pack_corpus`` must give identical rows. The masking cannot draw
``jax.random``'s bits, so the port keeps its draws apart from their use:
fed JAX's own draws (the three sub-keys of ``apply_mlm_masking``) it must
give identical corrupted ids, positions, labels and weights, and then the
same loss (1e-5 relative: f32 sum order) and gradients (1e-4 of each
tensor's largest value). The trainer is held to its own contract: it
learns, evaluates, checkpoints, stops on a preemption signal, resumes
mid-epoch bitwise, and its final model loads into the SPLADE encoder."""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splade_tpu.models.modernbert import ModernBertConfig as JaxConfig
from splade_tpu.models.modernbert import ModernBertForMaskedLM as JaxMLM
from splade_tpu.train import mlm as jax_mlm
from splade_tpu_torch.benchmark.encoders import SparseEncoderV33
from splade_tpu_torch.models.hf_port import params_from_jax
from splade_tpu_torch.models.modernbert import (ModernBertConfig,
                                                ModernBertForMaskedLM)
from splade_tpu_torch.models.splade import SpladeEncoder
from splade_tpu_torch.train import checkpoint as ckpt
from splade_tpu_torch.train import mlm
from splade_tpu_torch.train.mlm import (MaskDraws, MLMConfig, MLMTrainer,
                                        apply_mlm_masking, draw_mask_randoms,
                                        make_mlm_loss_fn, mask_seed,
                                        pack_corpus, read_corpus)

# tiny shapes: more intra-op threads only contend with the other test
# workers for the host's cores
torch.set_num_threads(1)

CLS, SEP, PAD, MASK = 2, 3, 0, 4
VOCAB = 97
SPECIALS = np.array([CLS, SEP, PAD, MASK])


class MLMFakeTokenizer:
    """tests/test_mlm.py's tokenizer"""

    cls_token_id = CLS
    sep_token_id = SEP
    pad_token_id = PAD
    mask_token_id = MASK
    all_special_ids = [CLS, SEP, PAD, MASK]

    def __len__(self):
        return VOCAB

    def get_vocab(self):
        return {"[PAD]": PAD, "[CLS]": CLS, "[SEP]": SEP, "[MASK]": MASK}

    def __call__(self, texts, add_special_tokens=False, padding=None,
                 truncation=True, max_length=16, return_tensors=None):
        ids = [[ord(c) % 90 + 5 for c in t if c != " "] for t in texts]
        if padding != "max_length":
            assert not add_special_tokens
            return {"input_ids": ids}
        out = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, row in enumerate(ids):
            row = row[:max_length]
            out[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return {"input_ids": out, "attention_mask": mask}

    def save_pretrained(self, path):
        pass


def korean_ish_corpus(n=400, seed=0):
    rng = np.random.default_rng(seed)
    words = ["검색", "모델", "한국어어", "문서다", "질의", "벡터값", "학습", "평가셋"]
    return [" ".join(rng.choice(words, size=rng.integers(3, 9)))
            for _ in range(n)]


# ---------------------------------------------------------------- packing
@pytest.mark.parametrize("max_length,batch_tokenize", [(32, 512), (16, 7)])
def test_pack_corpus_rows_identical_to_jax(max_length, batch_tokenize):
    tok = MLMFakeTokenizer()
    corpus = korean_ish_corpus() + ["a" * 100]  # one sentence spills rows
    want = jax_mlm.pack_corpus(corpus, tok, max_length, batch_tokenize)
    got = pack_corpus(corpus, tok, max_length, batch_tokenize)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (got[:, 0] == CLS).all() and (got[:-1] != PAD).all()
    with pytest.raises(ValueError, match="empty MLM corpus"):
        pack_corpus([], tok, max_length)


def test_read_corpus_reads_text_and_jsonl_shards(tmp_path):
    (tmp_path / "mlm_000.txt").write_text("가나 다라\n\n마바\n", "utf-8")
    (tmp_path / "extra.jsonl").write_text(
        json.dumps({"text": "사아"}, ensure_ascii=False) + "\n{broken\n"
        + json.dumps({"other": 1}) + "\n", "utf-8")
    got = list(read_corpus(str(tmp_path)))
    assert got == list(jax_mlm.read_corpus(str(tmp_path)))
    assert got == ["가나 다라", "마바", "사아", "{broken"]
    with pytest.raises(FileNotFoundError):
        list(read_corpus(str(tmp_path / "none")))


# ---------------------------------------------------------------- masking
def _jax_draws(key, B, S, P):
    """The draws jax's apply_mlm_masking makes from ``key``
    (splade_tpu/train/mlm.py:195-203), as the port's MaskDraws."""
    r_pos, r_op, r_tok = jax.random.split(key, 3)
    scores = jax.random.uniform(r_pos, (B, S), jnp.float32, minval=1e-6)
    op = jax.random.uniform(r_op, (B, P))
    rand_tok = jax.random.randint(r_tok, (B, P), 0, VOCAB)
    return MaskDraws(torch.from_numpy(np.asarray(scores)),
                     torch.from_numpy(np.asarray(op)),
                     torch.from_numpy(np.asarray(rand_tok)).long())


def _rows(rng, B, S):
    ids = rng.integers(5, VOCAB, size=(B, S)).astype(np.int32)
    ids[:, 0] = CLS
    ids[:, -1] = SEP
    ids[1, 4:] = PAD      # a short row: fewer eligible tokens than P
    ids[2, 1:] = PAD      # no eligible token at all
    return ids


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masking_identical_to_jax_given_its_draws(seed):
    B, S, P = 8, 32, 5
    ids = _rows(np.random.default_rng(seed), B, S)
    eligible = ((ids != PAD) & ~np.isin(ids, SPECIALS)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = [np.asarray(x) for x in jax_mlm.apply_mlm_masking(
        key, jnp.asarray(ids), jnp.asarray(eligible), P, MASK, VOCAB)]
    got = apply_mlm_masking(_jax_draws(key, B, S, P),
                            torch.from_numpy(ids).long(),
                            torch.from_numpy(eligible), P, MASK)
    for g, w, name in zip(got, want, ("corrupted", "positions", "labels",
                                      "weights")):
        assert np.array_equal(g.numpy(), w), name
    weights = got[3].numpy()
    # short rows get weight-0 picks: 3 eligible tokens in row 1, none in 2
    assert weights[1].sum() == 3.0 and weights[2].sum() == 0.0
    assert (weights[[0, 3]] == 1.0).all()


def test_port_draws_are_seeded_by_seed_step_and_micro_batch():
    """The same (seed, step, micro) draws the same numbers (what makes a
    resumed step exact); any other triple draws others; the ranges are
    jax's ([1e-6, 1), [0, 1), [0, vocab))."""
    def draw(*triple):
        gen = torch.Generator().manual_seed(mask_seed(*triple))
        return draw_mask_randoms(gen, 16, 64, 9, VOCAB)

    a, b = draw(42, 7, 1), draw(42, 7, 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for other in ((42, 7, 2), (42, 8, 1), (43, 7, 1)):
        assert not torch.equal(draw(*other).scores, a.scores)
    assert a.scores.min() >= 1e-6 and a.scores.max() < 1.0
    assert a.op.min() >= 0.0 and a.op.max() < 1.0
    assert a.rand_tokens.min() >= 0 and a.rand_tokens.max() < VOCAB
    # the 80/10/10 split over 64 rows x 9 picks (binomial tolerance)
    ids = torch.from_numpy(_rows(np.random.default_rng(0), 64, 64)).long()
    ids[1:3] = ids[3:5]
    eligible = torch.ones(64, 64)
    eligible[:, 0] = eligible[:, -1] = 0.0
    gen = torch.Generator().manual_seed(mask_seed(0, 0, 0))
    corrupted, positions, labels, weights = apply_mlm_masking(
        draw_mask_randoms(gen, 64, 64, 9, VOCAB), ids, eligible, 9, MASK)
    picked = torch.gather(corrupted, 1, positions)
    assert 0.70 <= float((picked == MASK).float().mean()) <= 0.90
    assert 0.05 <= float((picked == labels).float().mean()) <= 0.20
    assert all(len(set(r.tolist())) == 9 for r in positions)
    assert bool((weights == 1).all())


# ---------------------------------------------------------------- loss
@pytest.fixture(scope="module")
def jax_mlm_params():
    cfg = JaxConfig.tiny(num_hidden_layers=2, vocab_size=VOCAB)
    model = JaxMLM(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32),
                        jnp.ones((1, 16), jnp.int32))["params"]
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    params)
    params["decoder_bias"] = np.random.default_rng(0).normal(
        0, 0.3, params["decoder_bias"].shape).astype(np.float32)
    return model, params


def _port_mlm(params=None, seed=0):
    cfg = ModernBertConfig.tiny(num_hidden_layers=2, vocab_size=VOCAB)
    if params is None:
        return SpladeEncoder(cfg, device="cpu").init_weights(seed).mlm
    model = ModernBertForMaskedLM(cfg)
    model.load_state_dict(params_from_jax(params))
    return model


@pytest.mark.parametrize("seed", [0, 5])
def test_loss_and_gradients_match_jax_given_the_same_masking(jax_mlm_params,
                                                             seed):
    jmodel, params = jax_mlm_params
    S, B = 16, 6
    ids = _rows(np.random.default_rng(seed), B, S)
    jfn = jax_mlm.make_mlm_loss_fn(jmodel, MASK, VOCAB, SPECIALS, PAD, 0.15, S)
    key = jax.random.PRNGKey(seed)
    (jloss, jmet), jgrads = jax.value_and_grad(jfn, has_aux=True)(
        params, {"input_ids": jnp.asarray(ids)}, key)
    model = _port_mlm(params)
    P = mlm.masked_positions_per_row(0.15, S)
    assert P == 2
    tfn = make_mlm_loss_fn(model, MASK, VOCAB, SPECIALS, PAD, 0.15, S)
    tloss, tmet = tfn({"input_ids": torch.from_numpy(ids)},
                      _jax_draws(key, B, S, P))
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for name in ("mlm_acc", "masked_per_row"):
        np.testing.assert_allclose(float(tmet[name]), float(jmet[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    want = params_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), jgrads))
    for name, p in model.named_parameters():
        scale = max(float(want[name].abs().max()), 1e-12)
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=name)


def test_short_rows_contribute_nothing_to_the_loss():
    """A row without eligible tokens has weight-0 picks only: changing its
    'labels' cannot move the loss, and masked_per_row counts real picks."""
    model = _port_mlm()
    fn = make_mlm_loss_fn(model, MASK, VOCAB, SPECIALS, PAD, 0.25, 16)
    ids = torch.from_numpy(_rows(np.random.default_rng(3), 4, 16)).long()
    gen = lambda: torch.Generator().manual_seed(9)
    loss, met = fn({"input_ids": ids}, gen())
    ids2 = ids.clone()
    ids2[2, 0] = SEP  # the row with no eligible token
    loss2, _ = fn({"input_ids": ids2}, gen())
    assert float(loss) == float(loss2)
    # P = 4: rows 0 and 3 give 4 picks, row 1 gives 3, row 2 none
    assert float(met["masked_per_row"]) == pytest.approx(11 / 4, abs=1e-5)


# ---------------------------------------------------------------- trainer
def _cfg(out, **over):
    base = dict(data_dir="unused", output_dir=str(out), max_length=16,
                epochs=2, batch_size=1, grad_accum=2, lr=1e-3,
                logging_steps=1, save_steps=0, eval_steps=0,
                val_fraction=0.05, dtype="float32")
    base.update(over)
    return MLMConfig(**base)


@pytest.fixture(scope="module")
def rows():
    return pack_corpus(korean_ish_corpus(800), MLMFakeTokenizer(), 16)


def test_mlm_trainer_end_to_end(tmp_path, rows):
    tok = MLMFakeTokenizer()
    cfg = _cfg(tmp_path / "run", eval_steps=50, save_steps=120)
    trainer = MLMTrainer(cfg, _port_mlm(), rows, tok, device="cpu")
    # the same split and step count as the JAX trainer on one device
    n_val = int(len(rows) * 0.05)
    assert len(trainer.val_rows) == n_val
    assert trainer.steps_per_epoch == (len(rows) - n_val) // 2
    state = trainer.train()
    assert state.step == trainer.total_steps > 0
    out = tmp_path / "run"
    rec = [json.loads(l) for l in
           (out / "metrics.jsonl").read_text().splitlines()]
    first = np.mean([r["loss"] for r in rec[:10]])
    last = np.mean([r["loss"] for r in rec[-10:]])
    assert last < first
    assert {"loss", "mlm_acc", "masked_per_row", "tokens_per_sec",
            "epoch"} <= set(rec[-1])
    scores = trainer.evaluate()
    assert set(scores) == {"mlm_loss", "mlm_acc", "perplexity"}
    assert scores == trainer.evaluate()  # a fixed mask generator
    # save_steps wrote one mid-run checkpoint, train() the final one
    assert (out / "checkpoint_epoch1_step120").is_dir()
    latest = ckpt.find_latest_checkpoint(str(out))
    restored, meta = ckpt.load_checkpoint(latest, trainer.state)
    assert meta["full_resume"] and meta["step"] == state.step
    assert not trainer._watchdog._thread.is_alive()


def test_mlm_epoch_batches_are_jax_trainers(rows, tmp_path):
    """Batch order is a pure function of (seed, epoch): the port's epoch
    batches are the rows the JAX trainer's generator yields."""
    trainer = MLMTrainer(_cfg(tmp_path, val_fraction=0.0, batch_size=2),
                         _port_mlm(), rows, MLMFakeTokenizer(), device="cpu")
    rng = np.random.default_rng(trainer.cfg.seed + 3)
    order = rng.permutation(len(rows))
    first = next(iter(trainer._epoch_batches(3)))["input_ids"]
    assert first.shape == (2, 2, 16)
    assert np.array_equal(first.reshape(4, 16), rows[order[:4]])
    with pytest.raises(ValueError, match="corpus too small"):
        MLMTrainer(_cfg(tmp_path, batch_size=len(rows)), _port_mlm(),
                   rows, MLMFakeTokenizer(), device="cpu")


def test_mlm_preemption_checkpoints_and_stops(tmp_path, rows):
    cfg = _cfg(tmp_path / "run", epochs=100, logging_steps=10,
               val_fraction=0.0, watchdog_timeout_s=300.0)
    trainer = MLMTrainer(cfg, _port_mlm(), rows, MLMFakeTokenizer(),
                         device="cpu")
    replaced = trainer.install_preemption_handler()
    real_step = trainer.step_fn

    def step_then_signal(state, batch):
        if state.step == 4:  # SIGTERM lands inside the fifth step
            os.kill(os.getpid(), signal.SIGTERM)
        return real_step(state, batch)

    trainer.step_fn = step_then_signal
    try:
        state = trainer.train()
    finally:
        for sig, handler in replaced.items():
            signal.signal(sig, handler)
    assert trainer._preempted and state.step == 5 < trainer.total_steps
    latest = ckpt.find_latest_checkpoint(str(tmp_path / "run"))
    assert latest.endswith("checkpoint_epoch1_step5")
    assert not trainer._watchdog._thread.is_alive()


def test_mlm_mid_epoch_resume_is_bitwise_exact(tmp_path, rows):
    """The resumed run redraws the interrupted steps' masks (seeded from
    seed, step and micro-batch) and skips the consumed batches: its
    parameters equal the uninterrupted run's bitwise."""
    def mk(out, max_steps):
        cfg = _cfg(out, logging_steps=100, val_fraction=0.0,
                   max_steps=max_steps)
        return MLMTrainer(cfg, _port_mlm(seed=1), rows, MLMFakeTokenizer(),
                          device="cpu")

    spe = mk(tmp_path / "probe", 0).steps_per_epoch
    mid, target = spe // 2 + 1, spe + 1  # inside epoch 1; ends in epoch 2
    full = mk(tmp_path / "a", target).train()
    t_half = mk(tmp_path / "b", target)  # the same schedule, cut early
    t_half.cfg.max_steps = mid
    path = ckpt.save_checkpoint(str(tmp_path / "b"), t_half.train(), epoch=1)
    t_res = mk(tmp_path / "c", target)
    t_res.state, meta = ckpt.load_checkpoint(path, t_res.state)
    assert meta["full_resume"] and t_res.state.step == mid
    t_res.start_epoch = min(t_res.state.step // spe + 1, 2)
    res = t_res.train()
    assert res.step == full.step == target
    for a, b in zip(full.model.parameters(), res.model.parameters()):
        assert torch.equal(a, b)


def test_mlm_final_model_loads_into_splade_and_the_serving_encoder(tmp_path):
    """The final artifact (the bare MLM model under ``mlm.``) is a
    model-only checkpoint for the V33 trainer and loads through
    SparseEncoderV33.from_checkpoint."""
    from splade_tpu_torch.config.v33 import V33TrainingConfig
    from splade_tpu_torch.train.state import create_train_state

    mlm_model = _port_mlm(seed=2)
    path = ckpt.save_final_model(str(tmp_path), mlm_model, MLMFakeTokenizer(),
                                 prefix="mlm.")
    cfg = ModernBertConfig.tiny(num_hidden_layers=2, vocab_size=VOCAB)
    splade = SpladeEncoder(cfg, device="cpu").init_weights(5)
    state = create_train_state(splade, V33TrainingConfig(), 10)
    state, meta = ckpt.load_checkpoint(path, state)
    assert not meta["full_resume"]
    assert torch.equal(splade.mlm.decoder.weight, mlm_model.decoder.weight)
    assert torch.equal(splade.mlm.head.dense.weight,
                       mlm_model.head.dense.weight)
    enc = SparseEncoderV33.from_checkpoint(path, MLMFakeTokenizer(),
                                           device="cpu", config=cfg)
    assert torch.equal(enc.model.mlm.decoder.weight,
                       mlm_model.decoder.weight.to(torch.bfloat16))
    assert len(enc.encode_queries(["검색 모델"])) == 1


def test_mlm_config_env_and_yaml(tmp_path, monkeypatch):
    y = tmp_path / "mlm.yaml"
    y.write_text("epochs: 7\nlr: 1.0e-4\nmlm_probability: 0.2\n")
    monkeypatch.setenv("MLM_BATCH_SIZE", "13")
    monkeypatch.setenv("MLM_REMAT", "true")
    cfg = MLMConfig.load(str(y), {"seed": 99})
    jcfg = jax_mlm.MLMConfig.load(str(y), {"seed": 99})
    assert cfg.to_dict() == jcfg.to_dict()
    assert cfg.epochs == 7 and cfg.lr == 1e-4 and cfg.mlm_probability == 0.2
    assert cfg.batch_size == 13 and cfg.seed == 99 and cfg.remat is True
    with pytest.raises(ValueError):
        MLMConfig.load(None, {"nope": 1})
    # the repo's recipe loads, with the same values as in the JAX package
    recipe = "configs/pretrain_mlm.yaml"
    monkeypatch.delenv("MLM_BATCH_SIZE")
    monkeypatch.delenv("MLM_REMAT")
    assert (MLMConfig.load(recipe).to_dict()
            == jax_mlm.MLMConfig.load(recipe).to_dict())


def test_mlm_cli_trains_a_tiny_run(tmp_path, monkeypatch):
    """``python -m splade_tpu_torch.train mlm`` end to end on the CPU: a
    corpus dir, env and flag overrides, a final model the encoder loads,
    then ``--resume`` continues from the latest checkpoint."""
    from splade_tpu_torch.utils import tokenizer as tok_mod

    data = tmp_path / "corpus"
    data.mkdir()
    (data / "mlm_000.txt").write_text("\n".join(korean_ish_corpus(300)),
                                      "utf-8")
    monkeypatch.setattr(tok_mod, "create_tokenizer",
                        lambda path=None: MLMFakeTokenizer())
    from splade_tpu_torch.models import modernbert

    # main() builds the architecture's full widths; a tiny one here
    tiny = ModernBertConfig.tiny(num_hidden_layers=1, vocab_size=VOCAB)
    monkeypatch.setattr(
        modernbert, "ModernBertConfig",
        lambda **kw: ModernBertConfig.tiny(
            num_hidden_layers=1, vocab_size=kw["vocab_size"],
            pad_token_id=kw["pad_token_id"], remat=kw["remat"]))
    for name, value in {"MAX_LENGTH": "16", "GRAD_ACCUM": "2",
                        "LOGGING_STEPS": "1", "DTYPE": "float32",
                        "VAL_FRACTION": "0.0", "SAVE_STEPS": "0",
                        "EVAL_STEPS": "0"}.items():
        monkeypatch.setenv(f"MLM_{name}", value)
    out = tmp_path / "out"
    argv = ["--data-dir", str(data), "--output-dir", str(out), "--epochs",
            "1", "--batch-size", "2", "--lr", "1e-3", "--device", "cpu"]
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    try:
        assert mlm.main(argv + ["--max-steps", "3"]) == 0
        assert (out / "checkpoint_epoch1_step3" / "model.pt").exists()
        assert mlm.main(argv + ["--max-steps", "5", "--resume"]) == 0
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    assert (out / "checkpoint_epoch1_step5" / "training_state.pt").exists()
    assert json.loads((out / "resolved_config.json").read_text())[
        "max_length"] == 16
    enc = SparseEncoderV33.from_any(str(out / "final_model"),
                                    MLMFakeTokenizer(), device="cpu",
                                    config=tiny)
    assert enc.model.config.vocab_size == VOCAB
