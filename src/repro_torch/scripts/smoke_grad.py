"""Differentiable-engine smoke: the forward pin, gradients against finite
differences, and one Adam step (port of `scripts/smoke_grad.py`).

    python -m repro_torch.scripts.smoke_grad --device cpu

Three legs on a ``--devices`` fleet (default 64) over ``--periods``
(default 6); exit 1 on any failure:

  * *forward pin*: the straight-through rollout's value equals the hard
    rollout's summed accuracy (to 1e-8);
  * *grad vs FD*: `rollout_value_and_grad` in soft mode against central
    differences (eps 1e-5, rtol 1e-4 or atol 1e-6) on probed coordinates
    of ``p_es``, ``T`` and ``acc``, at a jittered ``p_es`` (the fleet's
    p_es sits on LP vertex kinks, where a central difference averages two
    one-sided slopes);
  * *Adam step*: one `torch.optim.Adam` step on (server-capacity scale,
    ladder-mix logit) strictly decreases an accuracy-SLO loss.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> int:
    import torch

    from .._device import resolve_device
    from ..api import engine as E
    from ..serving.fleet import H100_ES, FleetConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=64)
    ap.add_argument("--periods", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda (the default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_devices, periods = args.devices, args.periods
    f64 = dict(dtype=torch.float64, device=dev)
    failures = []
    cfg = FleetConfig(n_devices=n_devices, T=1.2, n_servers=4,
                      policy="amr2", rate=9.0, batch_max=8,
                      horizon=periods + 2, seed=0, straggler_frac=0.25,
                      outage_frac=0.1, **H100_ES)
    params = E.EngineParams.from_config(cfg, horizon=periods + 2,
                                        device=dev)

    def value(p):
        _, m = E.rollout(E.init_state(p, device=dev), p, periods,
                         device=dev)
        return float(m.total_accuracy.sum())

    def value_and_grad(p, wrt):
        return E.rollout_value_and_grad(E.init_state(p, device=dev), p,
                                        periods, wrt=wrt, device=dev)

    # ---- leg 1: forward pin --------------------------------------------
    hard = value(params)
    v_st, _ = value_and_grad(params.with_differentiable(smooth_mode="st"),
                             ("p_es",))
    if not abs(float(v_st) - hard) <= 1e-8:
        failures.append(f"st forward {float(v_st)!r} != hard {hard!r}")
    print(f"[forward] hard={hard:.6f} st={float(v_st):.6f}")

    # ---- leg 2: grad vs central FD (soft mode, jittered base) ----------
    rng = np.random.default_rng(7)
    shape = tuple(params.p_es.shape)
    nudge = (rng.uniform(1e-3, 3e-3, size=shape)
             * rng.choice([-1.0, 1.0], size=shape))
    soft = dataclasses.replace(
        params, p_es=params.p_es + torch.as_tensor(nudge, **f64)
    ).with_differentiable(smooth_mode="soft")
    val, grads = value_and_grad(soft, ("p_es", "T", "acc"))

    def fd(leaf, idx, eps=1e-5):
        base = getattr(soft, leaf)
        out = []
        for sgn in (+1.0, -1.0):
            pert = base.reshape(-1).clone()
            pert[idx] += sgn * eps
            out.append(value(dataclasses.replace(
                soft, **{leaf: pert.reshape(base.shape)})))
        return (out[0] - out[1]) / (2 * eps)

    probes = [("p_es", int(i)) for i in rng.choice(params.p_es.numel(), 3,
                                                   replace=False)]
    probes += [("T", 0), ("acc", int(rng.integers(soft.acc.numel())))]
    for leaf, idx in probes:
        an = float(grads[leaf].reshape(-1)[idx])
        num = fd(leaf, idx)
        rel = abs(num - an) / max(abs(num), abs(an), 1e-8)
        ok = rel < 1e-4 or abs(num - an) < 1e-6
        print(f"[fd] {leaf}[{idx}]: fd={num:+.6f} grad={an:+.6f} "
              f"rel={rel:.2e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"fd {leaf}[{idx}]: {num} vs {an}")

    # ---- leg 3: one Adam step decreases the SLO loss -------------------
    # knobs: log server-capacity scale on p_es, ladder-mix logit on acc;
    # the chain rule into knob space by hand from the leaf gradients
    slo = 0.98 * float(val) / (n_devices * periods)
    base_es, base_acc = soft.p_es, soft.acc
    n = n_devices * periods

    def loss_and_grads(log_cap: float, mix: float):
        p = dataclasses.replace(
            soft, p_es=base_es * np.exp(-log_cap),
            acc=base_acc * (2.0 / (1.0 + np.exp(-mix))))
        lv, g = value_and_grad(p, ("p_es", "acc"))
        d_cap = float((g["p_es"] * base_es * -np.exp(-log_cap)).sum())
        s = 1.0 / (1.0 + np.exp(-mix))
        d_mix = float((g["acc"] * base_acc * 2.0 * s * (1 - s)).sum())
        short = max(0.0, slo - float(lv) / n)
        dv = -2.0 * short / n              # d(shortfall^2)/d(value)
        return short ** 2, (dv * d_cap, dv * d_mix)

    knobs = torch.tensor([0.15, -0.5], dtype=torch.float64)
    opt = torch.optim.Adam([knobs], lr=5e-2)
    l0, g0 = loss_and_grads(*knobs.tolist())
    knobs.grad = torch.tensor(g0, dtype=torch.float64)
    opt.step()
    l1, _ = loss_and_grads(*knobs.tolist())
    print(f"[adam] slo_loss {l0:.3e} -> {l1:.3e}")
    if not l1 < l0:
        failures.append(f"Adam step did not decrease the SLO loss: "
                        f"{l0} -> {l1}")

    if failures:
        print("\nFAIL:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    print("\ngrad smoke OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
