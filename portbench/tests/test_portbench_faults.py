"""Runs of tiny cells on the CPU with the timed path broken underneath:
each fault a cell can have must bring ``correct`` out false.  (No cell
spans chips, so none can leave out an exchange between them.)"""
from __future__ import annotations

import pytest
import torch

from helpers import run_tiny


def _incorrect(tmp_path, workload):
    line = run_tiny(tmp_path, workload)
    assert line["correct"] is False, line["checks"]
    return line


@pytest.fixture
def engine():
    from repro_torch.api import engine as E
    return E


def test_fleet_step_returning_its_state_unchanged(tmp_path, monkeypatch,
                                                  engine):
    real = engine.step

    def stuck(state, params, **kw):
        _new, metrics = real(state, params, **kw)
        return state, metrics
    monkeypatch.setattr(engine, "step", stuck)
    _incorrect(tmp_path, "fleet102k-replay")


def test_fleet_half_the_fleet_left_out(tmp_path, monkeypatch, engine):
    real = engine._arrivals

    def half(state, params, t, fleet=None):
        ci, take, pending, head = real(state, params, t, fleet)
        cut = take.clone()
        cut[take.shape[0] // 2:] = 0
        return ci, cut, pending, head
    monkeypatch.setattr(engine, "_arrivals", half)
    _incorrect(tmp_path, "fleet102k-replay")


def test_fleet_plan_altered_where_it_is_made(tmp_path, monkeypatch, engine):
    real = engine._plan

    def altered(params, fp, warm_basis, lane_mask=None):
        assign, status, basis, xbar = real(params, fp, warm_basis,
                                           lane_mask)
        assign = assign.clone()
        assign[0, 0] = (assign[0, 0] + 1) % (fp.p_ed.shape[2] + 1)
        return assign, status, basis, xbar
    monkeypatch.setattr(engine, "_plan", altered)
    _incorrect(tmp_path, "fleet102k-replay")


@pytest.fixture
def models():
    from repro_torch import models
    return models


@pytest.mark.parametrize("workload", ["granite3b-es-offload",
                                      "granite3b-es-decode"])
def test_lm_token_altered_where_it_is_produced(tmp_path, monkeypatch,
                                              models, workload):
    real = models.logits_from_h

    def altered(params, h, cfg):
        # the last position of every row answers the token after its best
        logits = real(params, h, cfg)
        best = logits[:, -1].argmax(-1)
        rows = torch.arange(logits.shape[0])
        logits[rows, -1, (best + 1) % cfg.vocab_size] = 1e30
        return logits
    monkeypatch.setattr(models, "logits_from_h", altered)
    monkeypatch.setattr(models.model, "logits_from_h", altered)
    _incorrect(tmp_path, workload)


def test_lm_forward_half_the_batch_left_out(tmp_path, monkeypatch, models):
    real = models.forward

    def half(params, batch, cfg, **kw):
        tok = batch["tokens"]
        B = tok.shape[0]
        h = real(params, {"tokens": tok[:max(B // 2, 1)]}, cfg, **kw)
        return torch.cat([h, h], dim=0)[:B]
    monkeypatch.setattr(models, "forward", half)
    _incorrect(tmp_path, "granite3b-es-offload")


def test_lm_decode_step_returning_its_cache_unchanged(tmp_path,
                                                      monkeypatch, models):
    real = models.decode_step

    def stuck(params, tokens, cache, cfg):
        scratch = {**cache, "blocks": tuple(
            {k: v.clone() for k, v in blk.items()}
            for blk in cache["blocks"])}
        logits, _new = real(params, tokens, scratch, cfg)
        return logits, cache
    monkeypatch.setattr(models, "decode_step", stuck)
    _incorrect(tmp_path, "granite3b-es-decode")


def test_fleet_chaos_ladder_altered_where_it_runs(tmp_path, monkeypatch,
                                                  engine):
    """The ladder's retries left uncounted."""
    real = engine.realize_execution

    def altered(*args, **kw):
        rx = real(*args, **kw)
        return rx._replace(n_retries=rx.n_retries * 0)
    monkeypatch.setattr(engine, "realize_execution", altered)
    line = run_tiny(tmp_path, "fleet102k-chaos")
    assert line["correct"] is False, line["checks"]


def test_fleet_chaos_runs_correct(tmp_path):
    line = run_tiny(tmp_path, "fleet102k-chaos")
    assert line["correct"] is True, line["checks"]
