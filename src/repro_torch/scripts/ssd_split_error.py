"""The error of the SSD kernels' bfloat16 operand split, emulated on the
CPU before a kernel is built on it.

    python src/repro_torch/scripts/ssd_split_error.py

The bfloat16 kernels (`kernels/ssd_scan/csrc/ssd_scan.cu`) take every
float32 operand of their tensor-core products as K bfloat16 parts, each
the rounded rest of the ones before: L o C·Bᵀ dt against x for y's
diagonal blocks, (x w)ᵀ against B for each chunk's state, h_start against
C for the carried term.  This script computes those products from the
parts, each a float32 matrix product of bfloat16-valued operands (exact
products, float32 sums, as the tensor cores take them), with cum summed
in float64 as the kernels do, at the card phase's distributions
(`chip_smoke.ssd_inputs`: mamba2-130m's P 64, N 128, chunk 256, 24 heads,
S 2048, one row of the batch), and prints, for each split of `SPLITS`
(two parts, three parts, three with all but the last truncated as the
kernels take them) and for y and the final state, the error against the
float64 recurrence and against the plain version (`ref.ssd_chunked_ref`)
beside the card phase's bars: 1e-5 + twice and three times the plain
version's own error.  A CPU run: the
inputs come from `torch.manual_seed`, not the card's generator.
"""
from __future__ import annotations

import json
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref  # noqa: E402

H, P, N, Q, S = 24, 64, 128, 256, 2048
LOG2E = 1.4426950408889634
SPLITS = ((2, False), (3, False), (3, True))   # (parts, truncate)


def inputs(batch=1, seed=17):
    """x, dt, A, B, C in the kernel layout, x, B and C bfloat16-valued."""
    torch.manual_seed(seed)
    BH = batch * H
    x = torch.randn(BH, S, P).bfloat16().float()
    dt = F.softplus(0.3 * torch.randn(BH, S))
    A = (-torch.exp(0.2 * torch.randn(H)))[None].expand(batch, H) \
        .reshape(BH, 1)
    B, C = (torch.randn(batch, S, N).bfloat16().float() for _ in range(2))
    return x, dt, A, B, C


def exact(x, dt, A, B, C):
    """The recurrence in float64: (y, final state)."""
    BH = x.shape[0]
    heads = BH // B.shape[0]
    xd, dtd, Ad = x.double(), dt.double(), A.double()
    Bd = B.double().repeat_interleave(heads, 0)
    Cd = C.double().repeat_interleave(heads, 0)
    h = torch.zeros(BH, P, N, dtype=torch.float64)
    ys = torch.empty(BH, S, P, dtype=torch.float64)
    for t in range(S):
        h = h * torch.exp(dtd[:, t:t + 1] * Ad)[..., None] \
            + (dtd[:, t, None, None] * xd[:, t, :, None]) * Bd[:, t, None, :]
        ys[:, t] = torch.einsum("hpn,hn->hp", h, Cd[:, t])
    return ys, h


def split(v, parts, truncate=False):
    """v as ``parts`` bfloat16-valued float32 tensors summing to ~v, each
    the rounded rest of the ones before; with ``truncate`` every part but
    the last is the rest's upper 16 bits (truncated, as the kernels take
    them) and only the last is rounded."""
    out, rest = [], v
    for k in range(parts):
        if truncate and k < parts - 1:
            p = (rest.view(torch.int32) & -65536).view(torch.float32)
        else:
            p = rest.bfloat16().float()
        out.append(p)
        rest = rest - p
    return out


def emulated(x, dt, A, B, C, parts, truncate=False):
    """The kernels' chunked scan with each float32 operand in ``parts``
    bfloat16 parts (`split`)."""
    BH = x.shape[0]
    heads = BH // B.shape[0]
    Bh, Ch = (t.repeat_interleave(heads, 0) for t in (B, C))
    y = torch.empty(BH, S, P)
    h = torch.zeros(BH, P, N)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        d = dt[:, sl]
        cum2 = torch.cumsum(d.double() * A.double(), -1) * LOG2E
        w = torch.exp2((cum2[:, -1:] - cum2).float()) * d
        local = sum(torch.einsum("hsp,hsn->hpn", pt, Bh[:, sl])
                    for pt in split(x[:, sl] * w[..., None], parts,
                                    truncate))
        cb = Ch[:, sl] @ Bh[:, sl].transpose(1, 2)
        L = torch.exp2((cum2[:, :, None] - cum2[:, None, :]).float())
        M = torch.where(tri, L * cb * d[:, None, :], torch.zeros(()))
        diag = sum(pt @ x[:, sl] for pt in split(M, parts, truncate))
        carried = sum(torch.einsum("htn,hpn->htp", Ch[:, sl], pt)
                      for pt in split(h, parts, truncate))
        y[:, sl] = diag + carried * torch.exp2(cum2.float())[..., None]
        h = torch.exp2(cum2[:, -1]).float()[:, None, None] * h + local
    return y, h


def main() -> int:
    x, dt, A, B, C = inputs()
    ey, eh = exact(x, dt, A, B, C)
    py, ph = ssd_chunked_ref(x, dt, A, B, C, Q)
    for parts, truncate in SPLITS:
        ky, kh = emulated(x, dt, A, B, C, parts, truncate)
        for name, got, ex, plain in (("y", ky, ey, py), ("state", kh, eh,
                                                          ph)):
            own = (plain.double() - ex).abs().max().item()
            print(json.dumps(dict(
                parts=parts, truncate=truncate, out=name,
                err_vs_float64=(got.double() - ex).abs().max().item(),
                bar_vs_float64=1e-5 + 2 * own,
                err_vs_plain=(got - plain).abs().max().item(),
                bar_vs_plain=1e-5 + 3 * own, plain_own=own,
                scale=ex.abs().max().item())))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
