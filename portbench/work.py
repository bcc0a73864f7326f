"""The yardstick's arithmetic: the card's peaks and the operations and
bytes that each measured kernel and each model step need, from shapes
(and, for the simplex pivot, from the call's own inputs and flags).
Copies of the counts the port's `chip_smoke.py` keeps, so that no change
to the program moves them."""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_FP64_FLOPS = 34e12
PEAK_HBM_BYTES = 3.35e12
HBM_BYTES = 80e9


def bound_s(nbytes: float, flops: float, peak_flops: float) -> float:
    """The least time the card could take: bytes at the HBM rate or
    operations at ``peak_flops``, the larger."""
    return max(nbytes / PEAK_HBM_BYTES, flops / peak_flops)


def reduced_pivot_work(A, c_phase, Binv, basis, use_bland, may_pivot,
                       lane_ok, has_enter, unbounded, *, art_cost: float,
                       tol: float):
    """Bytes and FP64 operations one fused revised-simplex iteration
    (``reduced_pivot``) needs on these inputs, lane by lane, from its
    inputs before the call and its flags after it:

    * every lane reads ``lane_ok``, its factor ``Binv``, ``xB`` and
      ``basis``, and writes its three flags;
    * a lane with ``lane_ok`` False enters no column: its flags come from
      the ratio test on column 0 alone (R values of A, one FTRAN);
    * a lane with ``lane_ok`` True prices the columns that decide its
      entering index (all C0 under Dantzig or when none enters, columns
      0..j under Bland), reading them from A and c, plus c at its basic
      labels;
    * a lane that enters a column reads ``use_bland``, and ``may_pivot``
      too when its ratio test is bounded;
    * a lane that pivots writes ``Binv``, ``xB`` and one basis label.

    Labels >= C0 are virtual artificials priced at ``art_cost``."""
    import torch
    D, R, C0 = A.shape
    cB = torch.where(basis >= C0, art_cost, torch.gather(
        c_phase, 1, basis.long().clamp(0, C0 - 1)))
    y = torch.einsum("br,brk->bk", cB, Binv)
    rc = c_phase - torch.einsum("bk,bkc->bc", y, A)
    enter = (rc < -tol) & lane_ok[:, None]
    j_bland = enter.to(torch.uint8).argmax(dim=1)
    cols = torch.where(use_bland & has_enter, j_bland + 1, C0)
    cols = torch.where(lane_ok, cols, 0)
    col_idx = torch.arange(C0, device=A.device)
    basic = (basis[:, :, None] == col_idx) & lane_ok[:, None, None]
    c_read = (col_idx[None, :] < cols[:, None]) | basic.any(dim=1)
    n_cols = int(cols.sum())
    n_ok = int(lane_ok.sum())
    pivoted = int((may_pivot & has_enter & ~unbounded).sum())
    nbytes = (D * (1 + R * R * 8 + R * 8 + R * 4 + 3)
              + (D - n_ok) * R * 8
              + n_cols * R * 8 + int(c_read.sum()) * 8
              + int(has_enter.sum())
              + int((has_enter & ~unbounded).sum())
              + pivoted * (R * R * 8 + R * 8 + 4))
    flops = (n_ok * 2 * R * R + n_cols * (2 * R + 1)
             + D * (2 * R * R + R)
             + pivoted * 2 * R * (R + 1))
    return nbytes, flops


def live_pairs(Sq: int, Sk: int, mask: str, window: int = 0) -> int:
    """(query, key) pairs a mask keeps, for one row and head; queries sit
    at the last Sq positions of the Sk keys."""
    total = 0
    off = Sk - Sq
    for i in range(Sq):
        hi = off + i + 1 if mask in ("causal", "window") else Sk
        lo = max(0, hi - window) if mask == "window" else 0
        total += hi - lo
    return total


def flash_work(B, Sq, Sk, H, KH, D, mask, window, itemsize):
    """Bytes and operations one flash-attention call needs: q, k and v read
    once and o written once; 4 D operations (q.k and p.v, a multiply and an
    add each) per live (query, key) pair of each of the B H q-heads."""
    nbytes = itemsize * D * (2 * B * H * Sq + 2 * B * KH * Sk)
    return nbytes, 4 * D * B * H * live_pairs(Sq, Sk, mask, window)


def decode_work(B, H, KH, D, valid, itemsize, kv_itemsize):
    """Bytes and operations one flash-decode call needs: q read and o
    written once, the K and V rows of the ``valid`` cache slots of each of
    the B KH rows read once; 4 D operations per (q head, valid slot)."""
    nbytes = itemsize * 2 * B * H * D + kv_itemsize * 2 * B * KH * valid * D
    return nbytes, 4 * D * B * H * valid


def lm_dims(cfg: Dict) -> Dict[str, int]:
    """The sizes the model counts read, from a configuration file."""
    return dict(L=int(cfg["num_hidden_layers"]), d=int(cfg["hidden_size"]),
                H=int(cfg["num_attention_heads"]),
                KH=int(cfg["num_key_value_heads"]),
                Hd=int(cfg["hidden_size"]) // int(cfg["num_attention_heads"]),
                E=int(cfg["num_local_experts"]),
                K=int(cfg["num_experts_per_tok"]),
                F=int(cfg["intermediate_size"]),
                V=-(-int(cfg["vocab_size"]) // 128) * 128)


def lm_matmul_flops_per_token(cfg: Dict) -> int:
    """2 x the parameters one token multiplies by: per layer q, k, v, o,
    the router and its K experts' three matrices, then the output head
    (the embedding is a gather)."""
    s = lm_dims(cfg)
    d, Hd = s["d"], s["Hd"]
    per_layer = (d * s["H"] * Hd * 2 + d * s["KH"] * Hd * 2 + d * s["E"]
                 + s["K"] * 3 * d * s["F"])
    return 2 * (s["L"] * per_layer + d * s["V"])


def lm_attention_flops(cfg: Dict, B: int, Sq: int, Sk: int) -> int:
    """4 Hd operations per live causal (query, key) pair of each q head,
    over every layer."""
    s = lm_dims(cfg)
    return 4 * s["Hd"] * s["H"] * B * s["L"] * live_pairs(Sq, Sk, "causal")
