"""Data-parallel training over ``torch.distributed`` on the CPU
(``splade_tpu_torch.parallel``, the trainers with a process group, the
CLIs' ``--distributed``).

Real gloo process groups of two ranks: each rank is a subprocess of this
file (``python tests/test_torch_distributed.py worker SPEC``), joined
through a file in the test's tmp dir (no TCP port for parallel test
workers to race for), and every subprocess runs under a timeout, so a hang
fails the test. The CLIs run under ``torch.distributed.run --standalone``.
All rank processes start together in one module fixture. The references:

- JAX's ``make_train_step`` on a 2-device mesh, built as
  ``tests/test_multihost.py::_single_process_reference`` builds its own
  (the two per-process loaders' batches concatenated, rank 0 first): only
  the order of f32 sums differs, so losses and grad norms to 1e-5 relative;
- the same two halves taken in turn in one process, gradients combined as
  (g0 + g1) / 2 (``chip_smoke.emulate_ranks_step``): bitwise;
- the port's one process at the global batch (num_blocks 2 for V33, the
  global micro-batch's masks and count for MLM): 1e-6, relative for losses
  and grad norms, absolute for parameters (f32 sums in another order).

Workers import torch and the port only; JAX is imported by the tests.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
THIS = Path(__file__).resolve()
VOCAB = 512
LAYERS = 2
WORLD = 2
BATCH = 4   # rows a rank a micro-batch (V33)
ACCUM = 2
STEPS = 3
MLM_S = 16
MLM_VOCAB = 97
TIMEOUT_S = 240

# tiny shapes: more intra-op threads only contend with the other test
# workers for the host's cores
torch.set_num_threads(1)


class CharTok:
    """tests/multihost_worker.py's tokenizer (ids 3-99, [PAD] 0)."""

    pad_token_id = 0

    def __call__(self, texts, padding="max_length", truncation=True,
                 max_length=16, return_tensors=None):
        codes = [[ord(c) % 97 + 3 for c in t][:max_length] for t in texts]
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, row in enumerate(codes):
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def __len__(self):
        return VOCAB


class MLMTok:
    """tests/test_torch_mlm.py's tokenizer."""

    cls_token_id, sep_token_id, pad_token_id, mask_token_id = 2, 3, 0, 4
    all_special_ids = [2, 3, 0, 4]

    def __len__(self):
        return MLM_VOCAB

    def __call__(self, texts, add_special_tokens=False, **kw):
        return {"input_ids": [[ord(c) % 90 + 5 for c in t if c != " "]
                              for t in texts]}

    def save_pretrained(self, path):
        pass


def samples(n=64, seed=7):
    rng = np.random.default_rng(seed)
    words = ["검색", "모델", "한국어", "문서", "질의", "벡터"]
    mk = lambda: " ".join(rng.choice(words, size=4))
    return [{"query": mk(), "positive": mk(), "negative": mk()}
            for _ in range(n)]


def v33_cfg(out, **loss) -> dict:
    return {"model": {"dtype": "float32"}, "mesh": {"num_data": -1},
            "loss": {"flops_warmup_steps": 10, **loss},
            "data": {"batch_size": BATCH, "query_max_length": 8,
                     "doc_max_length": 16},
            "training": {"num_epochs": 1, "gradient_accumulation_steps": ACCUM,
                         "log_every_n_steps": 1, "save_every_n_epochs": 1,
                         "eval_every_n_epochs": 100, "learning_rate": 1e-3,
                         "output_dir": str(out)}}


def mlm_cfg(out, batch=2, **over):
    from splade_tpu_torch.train.mlm import MLMConfig

    return MLMConfig(**dict(dict(
        data_dir="unused", output_dir=str(out), max_length=MLM_S, epochs=1,
        batch_size=batch, grad_accum=2, lr=1e-3, logging_steps=1,
        save_steps=0, eval_steps=0, val_fraction=0.0, dtype="float32"),
        **over))


def collator():
    from splade_tpu_torch.data.collator import TripletCollator

    return TripletCollator(CharTok(), query_max_length=8, doc_max_length=16)


def v33_model(state_path):
    from splade_tpu_torch.models.modernbert import ModernBertConfig
    from splade_tpu_torch.models.splade import SpladeEncoder

    model = SpladeEncoder(ModernBertConfig.tiny(num_hidden_layers=LAYERS),
                          pool_impl="kernel", pool_tile=128,
                          with_token_weights=False, device="cpu")
    model.mlm.load_state_dict(torch.load(state_path, weights_only=True))
    return model


def mlm_model(state_path):
    from splade_tpu_torch.models.modernbert import (ModernBertConfig,
                                                    ModernBertForMaskedLM)

    model = ModernBertForMaskedLM(ModernBertConfig.tiny(
        num_hidden_layers=LAYERS, vocab_size=MLM_VOCAB))
    model.load_state_dict(torch.load(state_path, weights_only=True))
    return model


def recorded(trainer) -> list:
    """Every step's metrics as floats, on this rank."""
    records = []
    real = trainer.step_fn

    def step(state, batch):
        metrics = real(state, batch)
        records.append({k: float(v) for k, v in metrics.items()})
        return metrics

    trainer.step_fn = step
    return records


def load_chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ the workers
def job_v33(spec, mesh, out):
    """Three steps; a run cut after one step and resumed from rank 0's
    checkpoint; a resume path that differs across ranks; SIGTERM to rank
    1 alone during the second step; mesh.num_data other than the world."""
    from splade_tpu_torch.config import V33Config
    from splade_tpu_torch.train.checkpoint import (find_latest_checkpoint,
                                                   load_checkpoint)
    from splade_tpu_torch.train.cli import refuse_divergent_resume
    from splade_tpu_torch.train.trainer import Trainer

    rank = mesh.rank

    def trainer(run, **loss):
        cfg = V33Config.from_dict(v33_cfg(out / f"{run}_rank{rank}", **loss))
        return Trainer(cfg, v33_model(spec["init"]), samples(), collator(),
                       device="cpu", mesh=mesh)

    result = {}
    full = trainer("full", **spec.get("loss", {}))
    result["total_steps"] = full.total_steps
    full.cfg.training.max_steps = spec["steps"]
    result["records"] = recorded(full)
    full.train()
    torch.save({n: p.detach() for n, p in full.model.named_parameters()},
               out / f"params_rank{rank}.pt")
    if spec.get("loss"):
        return result
    # a run cut after one step (its epoch-end checkpoint), then resumed
    half = trainer("half")
    half.cfg.training.max_steps = 1
    half.train()
    path = find_latest_checkpoint(str(out / "half_rank0"))
    refuse_divergent_resume(path, mesh)
    res = trainer("resumed")
    res.state, meta = load_checkpoint(path, res.state)
    res.start_epoch = res.state.step // res.steps_per_epoch + 1
    res.cfg.training.max_steps = spec["steps"]
    res.train()
    result["resumed"] = dict(path=Path(path).name, step=res.state.step,
                             full_resume=meta["full_resume"],
                             bitwise=all(torch.equal(a, b) for a, b in zip(
                                 full.model.parameters(),
                                 res.model.parameters())))
    try:
        refuse_divergent_resume(f"{out}/checkpoint-of-rank{rank}", mesh)
        result["divergent_resume_refused"] = False
    except RuntimeError as e:
        result["divergent_resume_refused"] = "differs across ranks" in str(e)
    # SIGTERM reaches rank 1 only, inside the second step
    sig = trainer("sigterm")
    replaced = sig.install_preemption_handler()
    real = sig.step_fn

    def step_then_signal(state, batch):
        if rank == 1 and state.step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(state, batch)

    sig.step_fn = step_then_signal
    try:
        sig.train()
    finally:
        for s, handler in replaced.items():
            signal.signal(s, handler)
    result["sigterm"] = dict(step=sig.state.step, preempted=sig._preempted)
    try:
        bad = V33Config.from_dict(v33_cfg(out / "refused"))
        bad.mesh.num_data = 3
        Trainer(bad, v33_model(spec["init"]), samples(), collator(),
                device="cpu", mesh=mesh)
        result["num_data_refused"] = False
    except ValueError as e:
        result["num_data_refused"] = "not the world size 2" in str(e)
    return result


def job_mlm(spec, mesh, out):
    """One micro-batch fed the global draws of its masks (MaskDraws), its
    loss and reduced gradients; then two steps of MLMTrainer."""
    from splade_tpu_torch.parallel.mesh import (GradReducer, all_reduce_mean,
                                                all_reduce_sum)
    from splade_tpu_torch.train.mlm import MaskDraws, MLMTrainer

    rank = mesh.rank
    trainer = MLMTrainer(mlm_cfg(out / f"mlm_rank{rank}"),
                         mlm_model(spec["init"]), np.load(spec["rows"]),
                         MLMTok(), device="cpu", mesh=mesh)
    fed = torch.load(spec["draws"], weights_only=True)
    rows = slice(rank * 2, rank * 2 + 2)
    draws = MaskDraws(*(fed[k][rows] for k in ("scores", "op", "rand")))
    loss, _ = trainer.loss_fn({"input_ids": fed["ids"][rows]}, draws,
                              count=lambda t: all_reduce_sum(t, mesh),
                              world=mesh.world, rank=rank)
    loss.backward()
    params = [p for p in trainer.model.parameters() if p.grad is not None]
    GradReducer(mesh)([p.grad for p in params])
    torch.save({"loss": all_reduce_mean({"loss": loss}, mesh)["loss"],
                **{n: p.grad for n, p in trainer.model.named_parameters()
                   if p.grad is not None}}, out / f"fed_rank{rank}.pt")
    trainer.model.zero_grad(set_to_none=True)
    trainer.cfg.max_steps = 2
    records = recorded(trainer)
    trainer.train()
    torch.save({n: p.detach() for n, p in trainer.model.named_parameters()},
               out / f"params_rank{rank}.pt")
    return {"records": records, "total_steps": trainer.total_steps}


def worker(spec_path: str) -> int:
    """One rank: RANK and WORLD_SIZE from the environment, the process
    group through the spec's file, the job's result as rank{R}.json."""
    import torch.distributed as dist

    from splade_tpu_torch.parallel.mesh import init_distributed

    sys.modules["torch.utils.tensorboard"] = None  # TensorFlow's import time
    spec = json.loads(Path(spec_path).read_text())
    out = Path(spec_path).parent
    mesh = init_distributed("cpu", init_method=spec["init_method"])
    try:
        result = {"v33": job_v33, "mlm": job_mlm}[spec["job"]](spec, mesh,
                                                               out)
    finally:
        dist.destroy_process_group()
    (out / f"rank{mesh.rank}.json").write_text(json.dumps(result))
    return 0


def cli_worker(argv) -> int:
    """``tests/test_torch_distributed.py cli {v33,mlm} ARGS`` under
    torchrun: the CLI with the tests' tokenizers and a tiny model."""
    import dataclasses

    from splade_tpu_torch.models import modernbert
    from splade_tpu_torch.train import cli, mlm
    from splade_tpu_torch.utils import tokenizer

    sys.modules["torch.utils.tensorboard"] = None
    sub, rest = argv[0], argv[1:]
    tok = CharTok() if sub == "v33" else MLMTok()
    cli.create_tokenizer = tokenizer.create_tokenizer = lambda *a, **k: tok
    tiny = modernbert.ModernBertConfig.tiny(num_hidden_layers=1)
    modernbert.ModernBertConfig = lambda **kw: dataclasses.replace(tiny, **kw)
    return (cli.main if sub == "v33" else mlm.main)(rest)


# ------------------------------------------------------------ the launches
class Launched:
    """Processes started now, each with its own log file, awaited later
    under one deadline."""

    def __init__(self, what, commands, envs, logs):
        self.what, self.logs = what, logs
        self.procs = []
        for cmd, env, log in zip(commands, envs, logs):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    cmd, stdout=f, stderr=subprocess.STDOUT, env=env,
                    cwd=str(ROOT)))
        self._done = None

    def wait(self):
        if self._done is None:
            try:
                for proc in self.procs:
                    proc.wait(timeout=TIMEOUT_S)
            finally:
                for proc in self.procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            self._done = [(p.returncode, Path(log).read_text())
                          for p, log in zip(self.procs, self.logs)]
        for rc, text in self._done:
            assert rc == 0, f"{self.what}:\n{text[-4000:]}"


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    return dict(env, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **extra)


def launch_job(tmp: Path, job: str, **spec) -> Launched:
    tmp.mkdir(parents=True, exist_ok=True)
    spec = dict(spec, job=job, init_method=f"file://{tmp / 'group'}")
    (tmp / "spec.json").write_text(json.dumps(spec))
    return Launched(job, [[sys.executable, str(THIS), "worker",
                           str(tmp / "spec.json")]] * WORLD,
                    [_env(RANK=str(r), WORLD_SIZE=str(WORLD),
                          LOCAL_RANK=str(r)) for r in range(WORLD)],
                    [tmp / f"rank{r}.log" for r in range(WORLD)])


def launch_cli(tmp: Path, sub: str, args, **env) -> Launched:
    tmp.mkdir(parents=True, exist_ok=True)
    return Launched(f"{sub} CLI", [[
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc_per_node", str(WORLD), str(THIS), "cli", sub,
        "--distributed", "--device", "cpu", *args]], [_env(**env)],
        [tmp / "torchrun.log"])


def ranks(tmp: Path):
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(WORLD)]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """MetricWriter without TensorBoard (importing it imports TensorFlow,
    which takes seconds); its JSONL sink stays."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def jax_params():
    import jax
    import jax.numpy as jnp

    from splade_tpu.models.modernbert import ModernBertConfig as JaxMBConfig
    from splade_tpu.models.splade import SpladeEncoder as JaxSplade

    model = JaxSplade(JaxMBConfig.tiny(num_hidden_layers=LAYERS),
                      pool_impl="streamed", pool_tile=128)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        jax.jit(model.init)(jax.random.PRNGKey(0), ids,
                            jnp.ones_like(ids))["params"])
    params["mlm"]["decoder_bias"] = np.random.default_rng(0).normal(
        0, 0.3, params["mlm"]["decoder_bias"].shape).astype(np.float32)
    return params


def mlm_rows():
    """Packed rows of 16 tokens; the row that step 1's first global
    micro-batch gives rank 1 first is cut to [CLS] x [SEP] (one eligible
    token of the P = 2 picks), so the ranks' counts of masked positions
    differ."""
    from splade_tpu_torch.train.mlm import pack_corpus

    rng = np.random.default_rng(0)
    text = ["".join(chr(0xAC00 + int(c)) for c in rng.integers(0, 50, 9))
            for _ in range(300)]
    rows = pack_corpus(text, MLMTok(), MLM_S)[:64]
    order = np.random.default_rng(42 + 1).permutation(len(rows))
    short = order[2]  # step 1, micro-batch 0, global row 2 = rank 1's first
    rows[short] = 0
    rows[short, :3] = [2, 40, 3]
    return rows


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_params):
    """Every process group of this file, started at once."""
    from splade_tpu_torch.models.hf_port import params_from_jax
    from splade_tpu_torch.models.modernbert import ModernBertConfig
    from splade_tpu_torch.models.splade import SpladeEncoder
    from splade_tpu_torch.train.mlm import draw_mask_randoms

    root = tmp_path_factory.mktemp("dist")
    init = root / "v33_init.pt"
    torch.save(params_from_jax(jax_params), init)
    mlm_init = root / "mlm_init.pt"
    torch.save(SpladeEncoder(ModernBertConfig.tiny(
        num_hidden_layers=LAYERS, vocab_size=MLM_VOCAB),
        device="cpu").init_weights(3).mlm.state_dict(), mlm_init)
    rows = mlm_rows()
    np.save(root / "rows.npy", rows)
    gen = torch.Generator().manual_seed(5)
    fed = dict(zip(("scores", "op", "rand"), draw_mask_randoms(
        gen, 2 * WORLD, MLM_S, 2, MLM_VOCAB)))
    short = int(np.flatnonzero((rows > 0).sum(1) == 3)[0])
    fed["ids"] = torch.from_numpy(rows[[0, 1, short, 4]]).long()
    torch.save(fed, root / "draws.pt")

    data = root / "cli_data"
    data.mkdir()
    (data / "train_000.jsonl").write_text("\n".join(
        json.dumps(s, ensure_ascii=False) for s in samples(32)))
    (root / "cli.yaml").write_text(
        f"model:\n  dtype: float32\n"
        f"data:\n  train_files: ['{data / 'train_000.jsonl'}']\n"
        f"  val_files: []\n  batch_size: 2\n  query_max_length: 8\n"
        f"  doc_max_length: 16\n"
        f"training:\n  num_epochs: 1\n  gradient_accumulation_steps: 2\n"
        f"  log_every_n_steps: 1\n  max_steps: 3\n"
        f"  output_dir: {root / 'cli_v33' / 'out'}\n")
    corpus = root / "corpus"
    corpus.mkdir()
    (corpus / "mlm_000.txt").write_text("\n".join(
        " ".join(chr(0xAC00 + int(c)) for c in
                 np.random.default_rng(i).integers(0, 50, 12))
        for i in range(200)), "utf-8")
    launched = {
        "v33": launch_job(root / "v33", "v33", init=str(init), steps=STEPS),
        "global": launch_job(root / "global", "v33", init=str(init), steps=2,
                             loss={"global_in_batch_negatives": True}),
        "mlm": launch_job(root / "mlm", "mlm", init=str(mlm_init),
                          rows=str(root / "rows.npy"),
                          draws=str(root / "draws.pt")),
        "cli_v33": launch_cli(root / "cli_v33", "v33",
                              ["--config", str(root / "cli.yaml")]),
        "cli_mlm": launch_cli(root / "cli_mlm", "mlm", [
            "--data-dir", str(corpus), "--output-dir",
            str(root / "cli_mlm" / "out"), "--epochs", "1", "--batch-size",
            "2", "--max-steps", "3"], MLM_MAX_LENGTH=str(MLM_S),
            MLM_GRAD_ACCUM="2", MLM_LOGGING_STEPS="1", MLM_SAVE_STEPS="0",
            MLM_EVAL_STEPS="0", MLM_DTYPE="float32", MLM_VAL_FRACTION="0.0"),
    }
    yield root, launched
    for job in launched.values():
        for proc in job.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


# ------------------------------------------------------------ references
def jax_two_device_losses(jax_params, steps, **loss):
    """JAX's make_train_step on make_mesh(num_data=2): the two per-process
    loaders' batches concatenated, rank 0 first (test_multihost.py)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from splade_tpu.config.v33 import V33Config as JaxV33Config
    from splade_tpu.data.collator import TripletCollator as JaxCollator
    from splade_tpu.data.pipeline import create_dataloader
    from splade_tpu.models.modernbert import ModernBertConfig as JaxMBConfig
    from splade_tpu.models.splade import SpladeEncoder as JaxSplade
    from splade_tpu.parallel.mesh import make_mesh
    from splade_tpu.train.state import create_train_state
    from splade_tpu.train.trainer import (TENSOR_KEYS, make_train_step,
                                          stack_microbatches)

    cfg = JaxV33Config.from_dict(v33_cfg("unused", **loss))
    col = JaxCollator(CharTok(), query_max_length=8, doc_max_length=16)
    loaders = [create_dataloader(samples(), col, BATCH, shuffle=True,
                                 seed=cfg.training.seed, drop_last=True,
                                 process_index=p, process_count=WORLD)
               for p in range(WORLD)]
    for ld in loaders:
        ld.set_epoch(1)
    mesh = make_mesh(num_data=WORLD)
    model = JaxSplade(JaxMBConfig.tiny(num_hidden_layers=LAYERS),
                      pool_impl="streamed", pool_tile=128)
    state = create_train_state(jax.tree_util.tree_map(jnp.array, jax_params),
                               cfg.training, total_steps=4)
    step_fn = make_train_step(model, cfg, mesh, state.tx)
    sharding = NamedSharding(mesh, P(None, mesh.axis_names[0]))
    its = [iter(ld) for ld in loaders]
    p, o, s = state.params, state.opt_state, state.step
    out = []
    for _ in range(steps):
        micro = []
        for _ in range(ACCUM):
            parts = [next(it) for it in its]
            micro.append({k: np.concatenate([np.asarray(b[k]) for b in parts])
                          for k in TENSOR_KEYS if k in parts[0]})
        p, o, s, m = step_fn(p, o, s, jax.device_put(
            stack_microbatches(micro), sharding))
        out.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return out


def rank_batches(steps):
    """[step][rank] macro batches as each rank's Trainer loads them."""
    from splade_tpu_torch.data.pipeline import create_dataloader
    from splade_tpu_torch.train.trainer import stack_microbatches

    out = [[None] * WORLD for _ in range(steps)]
    for r in range(WORLD):
        loader = create_dataloader(samples(), collator(), BATCH, seed=42,
                                   process_index=r, process_count=WORLD,
                                   prefetch_depth=0)
        loader.set_epoch(1)
        micro = list(loader)[:ACCUM * steps]
        for s in range(steps):
            out[s][r] = {k: torch.from_numpy(v) for k, v in stack_microbatches(
                micro[s * ACCUM:(s + 1) * ACCUM]).items()}
    return out


def params_of(path):
    return torch.load(path, weights_only=True)


# ------------------------------------------------------------ tests
def test_two_ranks_match_jax_two_devices(runs, jax_params):
    """1: two ranks' V33 losses and grad norms (the ranks' mean) within
    1e-5 of JAX's two-device step."""
    root, launched = runs
    want = jax_two_device_losses(jax_params, 2)
    launched["v33"].wait()
    got = ranks(root / "v33")[0]["records"]
    for step, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                       err_msg=f"step {step + 1}: {k}")


def test_two_ranks_are_the_emulation_bitwise_and_the_global_batch(runs):
    """2: losses and parameters bitwise equal across ranks and to the two
    halves taken in turn, (g0 + g1) / 2; losses (and the first step's grad
    norm) within 1e-6 relative and parameters within 1e-6 of one process
    at the global batch with num_blocks 2."""
    from splade_tpu_torch.config import V33Config
    from splade_tpu_torch.train.state import create_train_state
    from splade_tpu_torch.train.trainer import make_train_step

    root, launched = runs
    launched["v33"].wait()
    res = ranks(root / "v33")
    assert res[0]["records"] == res[1]["records"]
    p0, p1 = (params_of(root / "v33" / f"params_rank{r}.pt")
              for r in range(WORLD))
    assert all(torch.equal(p0[n], p1[n]) for n in p0)

    cs = load_chip_smoke()
    cfg = V33Config.from_dict(v33_cfg("unused"))
    model = v33_model(root / "v33_init.pt")
    state = create_train_state(model, cfg.training, res[0]["total_steps"])
    batches = rank_batches(STEPS)
    emulated = [cs.emulate_ranks_step(
        torch, state, cfg.training.gradient_clip,
        [cs.v33_runs(torch, model, cfg, b, state.step) for b in step])
        for step in batches]
    assert [{k: r[k] for k in e} for r, e in
            zip(res[0]["records"], emulated)] == emulated
    assert all(torch.equal(p, p0["mlm." + n])
               for n, p in model.mlm.named_parameters())

    model = v33_model(root / "v33_init.pt")
    state = create_train_state(model, cfg.training, res[0]["total_steps"])
    step_fn = make_train_step(cfg, num_blocks=WORLD)
    for i, (step, rec) in enumerate(zip(batches, res[0]["records"])):
        joined = {k: torch.cat([b[k] for b in step], dim=1) for k in step[0]}
        m = step_fn(state, joined)
        # the grad norm from the same parameters (the first step); after
        # two AdamW updates the parameters differ by rounding (< 1e-6) and
        # the norm by up to a few 1e-6
        for k in ("loss", "infonce", "flops_q") + (("grad_norm",) if i == 0
                                                  else ()):
            np.testing.assert_allclose(rec[k], float(m[k]), rtol=1e-6,
                                       err_msg=f"step {i + 1}: {k}")
    for n, p in model.mlm.named_parameters():
        np.testing.assert_allclose(p0["mlm." + n].numpy(),
                                   p.detach().numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)


def test_global_in_batch_negatives_match_jax(runs, jax_params):
    """3: every rank's positives as candidates (all-gathered with a
    gradient, labels offset by rank x B): losses and grad norms within
    1e-5 of JAX's two-device step with the flag."""
    root, launched = runs
    want = jax_two_device_losses(jax_params, 2,
                                 global_in_batch_negatives=True)
    launched["global"].wait()
    res = ranks(root / "global")
    assert res[0]["records"] == res[1]["records"]
    plain = jax_two_device_losses(jax_params, 1)
    assert abs(want[0]["loss"] - plain[0]["loss"]) > 1e-3  # the flag bites
    for step, (g, w) in enumerate(zip(res[0]["records"], want)):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                       err_msg=f"step {step + 1}: {k}")


def test_mlm_two_ranks_equal_one_process_at_the_global_batch(runs):
    """4: a short row in rank 1's shard, so the ranks' counts of masked
    positions differ: two ranks' losses and parameters within 1e-6 of one
    process at the global batch, bitwise equal across ranks and to the
    halves in turn; and one micro-batch fed the same MaskDraws, the ranks'
    loss and reduced gradients against the global micro-batch's."""
    from splade_tpu_torch.train.mlm import MaskDraws, MLMTrainer

    root, launched = runs
    launched["mlm"].wait()
    res = ranks(root / "mlm")
    assert res[0]["records"] == res[1]["records"]
    p0, p1 = (params_of(root / "mlm" / f"params_rank{r}.pt")
              for r in range(WORLD))
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    rows = np.load(root / "rows.npy")

    one = MLMTrainer(mlm_cfg(root / "mlm_one", batch=2 * WORLD),
                     mlm_model(root / "mlm_init.pt"), rows, MLMTok(),
                     device="cpu")
    one.cfg.max_steps = 2
    records = recorded(one)
    one.train()
    for got, want in zip(res[0]["records"], records):
        for k in ("loss", "mlm_acc", "masked_per_row"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    for n, p in one.model.named_parameters():
        np.testing.assert_allclose(p0[n].numpy(), p.detach().numpy(),
                                   rtol=0, atol=1e-6, err_msg=n)
    # the short row did cut rank 1's count of masked positions
    first = next(one._epoch_batches(1))["input_ids"][0]
    assert (first[2] > 0).sum() == 3 and (first[:2] > 0).all()

    cs = load_chip_smoke()
    emu = MLMTrainer(mlm_cfg(root / "mlm_emulation", batch=2 * WORLD),
                     mlm_model(root / "mlm_init.pt"), rows, MLMTok(),
                     device="cpu")
    for _, host in zip(range(2), emu._epoch_batches(1)):
        ids = torch.from_numpy(host["input_ids"])
        out = cs.emulate_ranks_step(torch, emu.state, 1.0, cs.mlm_runs(
            torch, emu.loss_fn, [ids[:, r * 2:(r + 1) * 2]
                                 for r in range(WORLD)], 42, emu.state.step))
        rec = res[0]["records"][emu.state.step - 1]
        assert {k: rec[k] for k in rec} == {k: out[k] for k in rec}
    assert all(torch.equal(p, p0[n]) for n, p in emu.model.named_parameters())

    fed = torch.load(root / "draws.pt", weights_only=True)
    ranks_fed = params_of(root / "mlm" / "fed_rank0.pt")
    model = mlm_model(root / "mlm_init.pt")
    loss, _ = MLMTrainer(mlm_cfg(root / "fed"), model, rows, MLMTok(),
                         device="cpu").loss_fn(
        {"input_ids": fed["ids"]}, MaskDraws(fed["scores"], fed["op"],
                                             fed["rand"]))
    loss.backward()
    np.testing.assert_allclose(float(ranks_fed["loss"]), float(loss),
                               rtol=1e-6)
    for n, p in model.named_parameters():
        scale = max(float(p.grad.abs().max()), 1e-12)
        np.testing.assert_allclose(ranks_fed[n].numpy(), p.grad.numpy(),
                                   rtol=0, atol=1e-6 * scale, err_msg=n)


def test_rank_zero_writes_and_a_world_two_resume_is_bitwise(runs):
    """5: nothing under any directory of rank 1 (checkpoints, metrics,
    events); rank 0's checkpoints; a run cut after one step and resumed
    from rank 0's checkpoint on both ranks ends bitwise equal."""
    root, launched = runs
    launched["v33"].wait()
    r0, r1 = ranks(root / "v33")
    assert not list((root / "v33").glob("*_rank1"))
    assert (root / "v33" / "full_rank0" / "checkpoint_epoch1_step3").is_dir()
    assert (root / "v33" / "full_rank0" / "metrics.jsonl").exists()
    for r in (r0, r1):
        assert r["resumed"] == dict(path="checkpoint_epoch1_step1", step=3,
                                    full_resume=True, bitwise=True)


def test_a_checkpoint_that_differs_across_ranks_is_refused(runs):
    """6: both ranks raise, none carries on alone."""
    root, launched = runs
    launched["v33"].wait()
    assert all(r["divergent_resume_refused"] for r in ranks(root / "v33"))


def test_sigterm_to_one_rank_stops_every_rank_at_one_step(runs):
    """7: SIGTERM to rank 1 inside step 2: both ranks stop after step 2,
    one checkpoint (rank 0's) is written, and the run ends (no hang)."""
    root, launched = runs
    launched["v33"].wait()
    for r in ranks(root / "v33"):
        assert r["sigterm"] == {"step": 2, "preempted": True}
    assert [p.name for p in (root / "v33" / "sigterm_rank0").glob(
        "checkpoint_*")] == ["checkpoint_epoch1_step2"]


def test_num_data_other_than_the_world_is_refused(runs):
    """8: mesh.num_data 3 at a world of 2 (and 2 with no process group)."""
    from splade_tpu_torch.config import V33Config
    from splade_tpu_torch.parallel.mesh import DataMesh
    from splade_tpu_torch.train.trainer import check_num_data

    root, launched = runs
    launched["v33"].wait()
    assert all(r["num_data_refused"] for r in ranks(root / "v33"))
    with pytest.raises(ValueError, match="not the world size 1"):
        check_num_data(2, DataMesh())
    for ok in (-1, 0, 2):
        check_num_data(ok, DataMesh(world=2, backend="gloo"))
    assert V33Config().mesh.num_data == -1


def test_world_one_over_gloo_is_bitwise_no_process_group(tmp_path,
                                                         jax_params):
    """9: the Trainer in a gloo group of one rank (the reduction runs)
    equals the Trainer without a process group, bitwise."""
    import torch.distributed as dist

    from splade_tpu_torch.config import V33Config
    from splade_tpu_torch.models.hf_port import params_from_jax
    from splade_tpu_torch.parallel.mesh import init_distributed
    from splade_tpu_torch.train.trainer import Trainer

    init = tmp_path / "init.pt"
    torch.save(params_from_jax(jax_params), init)
    out = []
    for grouped in (False, True):
        mesh = None
        if grouped:
            os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
            mesh = init_distributed("cpu",
                                    init_method=f"file://{tmp_path / 'g'}")
        try:
            tr = Trainer(V33Config.from_dict(v33_cfg(tmp_path / str(grouped))),
                         v33_model(init), samples(), collator(), device="cpu",
                         mesh=mesh)
            tr.cfg.training.max_steps = 2
            records = recorded(tr)
            tr.train()
            assert (tr.reducer is not None) == grouped
            out.append((records, [p.detach().clone()
                                  for p in tr.model.parameters()]))
        finally:
            if grouped:
                dist.destroy_process_group()
                for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
                    os.environ.pop(k)
    (a, pa), (b, pb) = out
    assert a == b and all(torch.equal(x, y) for x, y in zip(pa, pb))


def test_device_is_local_rank_and_set_before_the_model(monkeypatch,
                                                       tmp_path):
    """10: with a faked CUDA, resolve_device(None) and ("cuda") are
    cuda:{LOCAL_RANK} (a device with an index, or the CPU, wins), and the
    CLI's --distributed sets that device, then joins the group (NCCL) and
    makes the host decisions' gloo group, before the model is built."""
    import torch.distributed as dist

    from splade_tpu_torch.models import splade
    from splade_tpu_torch.train import cli
    from splade_tpu_torch.utils.runtime import resolve_device

    events = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: events.append(("set_device", str(d))))
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw:
                        events.append(("init_process_group", backend)))
    monkeypatch.setattr(dist, "new_group", lambda backend=None, **kw:
                        events.append(("new_group", backend)))
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda: events.append(("destroy_process_group",)))
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert resolve_device(None) == torch.device("cuda:3")
    assert resolve_device("cuda") == torch.device("cuda:3")
    assert resolve_device("cuda:0") == torch.device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK")
    assert resolve_device(None) == torch.device("cuda")

    class Built(Exception):
        pass

    def model(*a, **kw):
        events.append(("model", str(kw.get("device"))))
        raise Built

    monkeypatch.setattr(splade, "SpladeEncoder", model)
    monkeypatch.setattr(cli, "create_tokenizer", lambda *a, **k: CharTok())
    data = tmp_path / "train_000.jsonl"
    data.write_text(json.dumps(samples(1)[0], ensure_ascii=False))
    for k, v in dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1",
                     MASTER_ADDR="localhost", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("TRAIN_DATA__TRAIN_FILES", str(data))
    with pytest.raises(Built):
        cli.main(["--distributed", "--output-dir", str(tmp_path / "out")])
    assert events == [("set_device", "cuda:1"), ("init_process_group", "nccl"),
                      ("new_group", "gloo"), ("model", "cuda:1"),
                      ("destroy_process_group",)]


def test_both_clis_train_under_torchrun(runs):
    """11: ``torchrun --nproc_per_node 2 -m splade_tpu_torch.train
    {v33,mlm} --distributed --device cpu``: three steps each, rank 0 alone
    writes the log, the metrics, the checkpoint and the final model."""
    root, launched = runs
    for sub, out in (("v33", root / "cli_v33" / "out"),
                     ("mlm", root / "cli_mlm" / "out")):
        launched[f"cli_{sub}"].wait()
        records = [json.loads(line) for line in
                   (out / "metrics.jsonl").read_text().splitlines()]
        assert [r["step"] for r in records] == [1, 2, 3], sub
        assert all(r["allreduce_ms"] >= 0 for r in records)
        assert (out / "final_model" / "model.pt").exists()
        assert (out / "resolved_config.json").exists()
        assert "rank 0 of 2" in (out / "training.log").read_text()
        assert "rank 1 of 2" not in (out / "training.log").read_text()
    assert list((root / "cli_mlm" / "out").glob("checkpoint_epoch1_step3"))
    # global batch 2 x 2 ranks: 8 triplets a step of accumulation 2
    assert json.loads((root / "cli_v33" / "out" / "resolved_config.json")
                      .read_text())["data"]["batch_size"] == 2


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        sys.exit(worker(sys.argv[2]))
    sys.exit(cli_worker(sys.argv[2:]))
