"""A run with the timed path broken underneath comes out not correct; a
sound run comes out correct. Each drives ``core.run_cell`` on the CPU at
a small size (the look for a card skipped) with the cell's own limits."""

import pytest
import torch

from conftest import small
from h100_bench import core, spec

BENCH = spec.benchmark()
SEED = 2 ** 31 + 31337


def _run(cell):
    result, _ = core.run_cell(small(spec.Cell(BENCH, cell)), SEED, 0.5,
                              False, device="cpu")
    return result


def _broken_step(monkeypatch, wrap):
    from closerlook3d_tpu_torch.train import step as step_mod

    make = step_mod.make_train_step
    monkeypatch.setattr(step_mod, "make_train_step",
                        lambda *a, **k: wrap(make(*a, **k)))


def unchanged(step):
    """Steps, then hands back the state as it was."""
    def broken(state, batch, seed):
        before = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()}
        out = step(state, batch, seed)
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(before[n])
        state.optimizer.state.clear()
        return out
    return broken


def half_batch(step):
    """Steps on the first half of the batch: the mean over the rest."""
    def broken(state, batch, seed):
        half = batch["xyz"].shape[0] // 2
        return step(state, {k: v[:half] for k, v in batch.items()}, seed)
    return broken


@pytest.mark.parametrize("cell", ["partnet-xyz.train", "partnet-pwmlp.train"])
def test_sound_train_run_is_correct(cell):
    assert _run(cell)["correct"] is True


@pytest.mark.parametrize("fault", [unchanged, half_batch])
@pytest.mark.parametrize("cell", ["partnet-xyz.train", "partnet-pwmlp.train"])
def test_broken_train_step_is_not_correct(monkeypatch, cell, fault):
    _broken_step(monkeypatch, fault)
    result = _run(cell)
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in result["checks"].values())


def _broken_predictor(monkeypatch, alter):
    from closerlook3d_tpu_torch.serving.predictor import Predictor

    call = Predictor.__call__
    monkeypatch.setattr(Predictor, "__call__",
                        lambda self, *a: alter(call(self, *a)))


def altered_answer(out):
    """One cloud's answer altered where it is made: its logits negated,
    every point's ranking of the parts reversed."""
    out = out.clone()
    out[0] = -out[0]
    return out


def half_answered(out):
    """Half of the batch left out: its logits never computed."""
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


@pytest.mark.parametrize("cell", ["partnet-xyz.serve", "partnet-pwmlp.serve"])
def test_sound_serve_run_is_correct(cell):
    assert _run(cell)["correct"] is True


@pytest.mark.parametrize("fault", [altered_answer, half_answered])
@pytest.mark.parametrize("cell", ["partnet-xyz.serve", "partnet-pwmlp.serve"])
def test_broken_predictor_is_not_correct(monkeypatch, cell, fault):
    _broken_predictor(monkeypatch, fault)
    assert _run(cell)["correct"] is False
