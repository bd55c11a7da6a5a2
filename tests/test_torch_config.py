"""The port's config loader reads a ``.json`` config as well as YAML: the
format ``save_config`` writes by default, and the one a machine without
PyYAML can give the V33 CLI's ``--config``. The legacy (V22-era) knobs of
``config/legacy.py`` validate as the reference's."""

import dataclasses
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


LEGACY_CASES = {
    "defaults": ({}, {}),
    "bad_batch_and_loss": ({"batch_size": 0},
                           {"temperature": -1, "lambda_infonce": 0,
                            "lambda_margin": 0}),
    "every_problem": ({"batch_size": -1, "learning_rate": 0,
                       "num_epochs": 0},
                      {"lambda_self": -1, "lambda_flops": -0.1,
                       "margin": 3.0, "curriculum_temperature": 0}),
    "margin_edges": ({}, {"margin": 2.0, "lambda_min_act": 0.0}),
}


@pytest.mark.parametrize("case", sorted(LEGACY_CASES))
def test_legacy_config_validates_as_the_reference(case):
    """config/legacy.py is a copy: the same fields and defaults, and
    validate() lists the same problems in the same order."""
    from splade_tpu.config import legacy as ref
    from splade_tpu_torch.config import legacy as port

    train_kw, loss_kw = LEGACY_CASES[case]
    got, want = [m.LegacyTrainConfig(loss=m.LegacyLossConfig(**loss_kw),
                                     **train_kw) for m in (port, ref)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.validate() == want.validate()
    assert got.loss.validate() == want.loss.validate()
    if case == "defaults":
        assert got.validate() == []
    if case == "bad_batch_and_loss":
        problems = got.validate()
        for word in ("batch_size", "temperature", "ranking loss"):
            assert any(word in p for p in problems), word
