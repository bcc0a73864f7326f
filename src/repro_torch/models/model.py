"""The LM of the port (`repro.models.model`): `init_params`, `forward`,
`logits_from_h`, the generation path `init_cache`, `prefill` and
`decode_step`, and the sharding metadata `param_axes`, `cache_axes` and
`cache_specs` (ROADMAP §1 item 13).

Layout: ``num_layers = n_cycles * len(pattern) + tail``.  The parameters
keep the reference's pytree: ``embed`` (V, D), ``unembed`` (D, V),
``final_norm`` (D,), ``blocks`` — one dict per pattern position, each leaf
stacked over the cycles — and ``tail``, one unstacked dict per tail layer.
The cache keeps the reference's layout too: ``blocks[k][name]`` stacked
over the cycles, ``tail[t][name]``, then ``index``, the absolute position
of the next token — a Python int here (a device scalar would cost a host
sync in every layer to find the ring slot).  Where the reference scans
over the stacked cycles (`lax.scan`), the port runs a Python loop over
them and then over the tail.  A plain large matrix product (the
projections, ``h @ unembed``) stays `torch.matmul`; attention, the SSD
scan and the RG-LRU recurrence are the hand-written kernels (`layers`).

An encoder-decoder model (whisper) also has ``encoder`` (its "enc"
layers' leaves stacked over ``encoder_layers``), ``enc_pos`` and
``enc_norm``: `forward` and `prefill` encode ``batch["audio_feats"]``
once (`_encode`) and every "dec" layer attends to the result, which the
cache carries as ``enc_out`` for `decode_step`.  A VLM (internvl2) takes
``batch["patch_embeds"]`` (B, num_patches, D) in place of its first
``num_patches`` token embeddings.

Training (ROADMAP §1 item 12.5): `loss_fn` is the reference's next-token
cross-entropy (`_xent`; vocabulary padding masked in `logits_from_h`;
with ``cfg.logit_chunk`` over sequence chunks, each checkpointed, plus
the remainder).  `forward` runs each cycle of the pattern through
`_maybe_remat` (``cfg.remat``: ``"none"``, ``"full"`` — the cycle's
activations recomputed in the backward — or ``"dots"`` — the outputs of
products without batch dimensions kept and the rest recomputed, the
counterpart of `dots_with_no_batch_dims_saveable`) and puts the
reference's `grad_dtype_barrier` at each cycle's block boundaries.
Under autograd attention, the SSD and the RG-LRU take their plain paths
(`layers`); ``impl="pallas"`` then raises.  `param_shapes` gives the
parameter tree on the ``meta`` device, allocating nothing.

Sharded (ROADMAP §1 item 13): the same functions run on DTensor
parameters distributed by `distributed.sharding` inside its
`sharding_context`.  The reference's activation constraints
(`shard_activation`) sit at its call sites, and after each tail layer
too; each layer's parameters are gathered over the data-parallel mesh
dims at use (`gather_params`, FSDP style); a DTensor loss takes its gold
logit by a one-hot select; the kernels run on each rank's own rows
(`layers`), and a prefill's cache leaves are put on their logical axes
(`cache_axes`) for decode's in-place writes.  Without a context every
one of these is the plain tensor's own path.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .._device import DeviceLike, resolve_device
from ..distributed.sharding import gather_params, shard_activation, unshard
from .config import ModelConfig
from .layers import (NEG_INF, attn_cache_len, block_apply, block_decode,
                     block_param_defs, checkpointed, grad_dtype_barrier,
                     rms_norm, torch_dtype, zeros_of)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _init_leaf(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in), fan_in as the reference computes it (the
    leading dims of a >= 2-d leaf, stacking axis included)."""
    fan_in = shape[0] if len(shape) == 1 else int(np.prod(shape[:-1]))
    t = torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
    return t.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(device)


def _param_tree(cfg: ModelConfig, leaf: Callable, zeros: Callable
                ) -> Params:
    """The parameter tree with ``leaf(shape)`` for each drawn leaf, in the
    draw order (embed, unembed, then each pattern position's and tail
    layer's leaves by name, an encoder's last), and ``zeros(shape)`` for
    the norms' scales."""
    n_cycles, tail = cfg.cycles_and_tail
    V, D = cfg.padded_vocab, cfg.d_model

    def block(defs, n_stack):
        return {name: leaf((n_stack,) + shape if n_stack else shape)
                for name, (shape, _axes) in sorted(defs.items())}

    params: Params = {"embed": leaf((V, D)), "unembed": leaf((D, V)),
                      "final_norm": zeros((D,))}
    params["blocks"] = tuple(
        block(block_param_defs(cfg, mixer, ffn), n_cycles)
        for mixer, ffn in cfg.pattern)
    params["tail"] = tuple(block(block_param_defs(cfg, *cfg.pattern[t]), 0)
                           for t in range(tail))
    if cfg.is_encdec:
        params["encoder"] = block(block_param_defs(cfg, "enc", "gelu"),
                                  cfg.encoder_layers)
        params["enc_pos"] = leaf((cfg.encoder_seq, D))
        params["enc_norm"] = zeros((D,))
    return params


def init_params(cfg: ModelConfig, generator: Union[int, torch.Generator],
                device: DeviceLike = None) -> Params:
    """Random parameters in the reference's layout and scale.

    ``generator`` is a `torch.Generator` or an integer seed (a generator
    on ``device`` is then made from it); leaves are drawn in a fixed order
    (embed, unembed, then each pattern position's and tail layer's leaves
    by name).  `torch` and `jax.random` give different numbers from one
    seed: carry the reference's parameters across with
    `convert.model_params_from_numpy` to compute the same thing.  An
    encoder-decoder model's ``encoder``, ``enc_pos`` and ``enc_norm``
    come last, as in the reference."""
    dev = resolve_device(device)
    gen = (torch.Generator(device=dev).manual_seed(generator)
           if isinstance(generator, int) else generator)
    pd = torch_dtype(cfg.param_dtype)
    return _param_tree(
        cfg, lambda shape: _init_leaf(gen, shape, pd, dev),
        lambda shape: torch.zeros(shape, dtype=pd, device=dev))


def _block_axes(defs, stacked: bool):
    return {name: (("layers",) + axes if stacked else axes)
            for name, (_shape, axes) in sorted(defs.items())}


def param_axes(cfg: ModelConfig) -> Params:
    """The parameter tree's logical axes, one tuple per leaf (names the
    sharding rules map onto mesh axes, `distributed.sharding`): a stacked
    leaf's first axis is ``"layers"``."""
    n_cycles, tail = cfg.cycles_and_tail
    axes: Params = {
        # the input table has its own axes: a gather from a
        # vocab-sharded table replicates it whole on every rank
        "embed": ("in_vocab", "in_embed"),
        "unembed": ("embed", "vocab"),
        "final_norm": ("embed",),
    }
    axes["blocks"] = tuple(
        _block_axes(block_param_defs(cfg, m, f), stacked=n_cycles > 0)
        for (m, f) in cfg.pattern)
    axes["tail"] = tuple(
        _block_axes(block_param_defs(cfg, *cfg.pattern[t]), stacked=False)
        for t in range(tail))
    if cfg.is_encdec:
        axes["encoder"] = _block_axes(block_param_defs(cfg, "enc", "gelu"),
                                      stacked=True)
        axes["enc_pos"] = (None, "embed")
        axes["enc_norm"] = ("embed",)
    return axes


def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree of ``cfg`` on the ``meta`` device: shapes and
    dtypes, nothing allocated (the reference's `jax.eval_shape` of
    `init_params`)."""
    pd = torch_dtype(cfg.param_dtype)

    def empty(shape):
        return torch.empty(shape, dtype=pd, device="meta")
    return _param_tree(cfg, empty, empty)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _embed_inputs(params: Params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings in the compute dtype; a VLM's ``patch_embeds``
    (B, num_patches, D), cast to it, replace the first num_patches
    positions."""
    table = gather_params(params["embed"])
    dt = torch_dtype(cfg.dtype)
    tokens = torch.as_tensor(batch["tokens"], device=table.device)
    x = F.embedding(tokens.long(), table).to(dt)
    if cfg.num_patches and "patch_embeds" in batch:
        pe = torch.as_tensor(batch["patch_embeds"], device=table.device)
        x = torch.cat([pe.to(dt), x[:, cfg.num_patches:]], dim=1)
    return x


def _encode(params: Params, batch, cfg: ModelConfig, impl: str
            ) -> torch.Tensor:
    """The encoder over ``batch["audio_feats"]`` (B, encoder_seq, D) of
    precomputed frame embeddings: plus ``enc_pos``, the unmasked "enc"
    layers without RoPE, then ``enc_norm``; (B, encoder_seq, D) in the
    compute dtype."""
    dt = torch_dtype(cfg.dtype)
    pos_table = params["enc_pos"]
    feats = torch.as_tensor(batch["audio_feats"], device=pos_table.device)
    x = feats.to(dt) + pos_table.to(dt)[None]
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for layer in range(cfg.encoder_layers):
        lp = gather_params({n: t[layer] for n, t in
                            params["encoder"].items()})
        x, _ = block_apply(lp, x, "enc", "gelu", cfg, positions, impl=impl)
    return rms_norm(x, gather_params(params["enc_norm"]), cfg.norm_eps)


def forward(params: Params, batch, cfg: ModelConfig, *,
            impl: str = "pallas") -> torch.Tensor:
    """Final hidden states (B, S, D) in the compute dtype — logits via
    `logits_from_h`.  ``batch["tokens"]`` is (B, S) integers.

    ``impl`` chooses the SSD scan and the RG-LRU recurrence, with the
    reference's values: ``"pallas"`` is the hand-written kernel (its plain
    version on a CPU tensor), ``"jnp"`` the plain path (the chunked SSD
    scan, the log-step RG-LRU scan).  The port defaults to the kernel, as
    its ``attn_impl="auto"`` does for attention; the reference defaults to
    ``"jnp"`` (and always inlines its RG-LRU scan).  Attention follows
    ``cfg.attn_impl``.  An encoder-decoder model also takes
    ``batch["audio_feats"]``, a VLM ``batch["patch_embeds"]``."""
    x, positions, enc_out = _start(params, batch, cfg, impl)
    n_cycles, tail = cfg.cycles_and_tail

    def cycle(x, c):
        for k, (mixer, ffn) in enumerate(cfg.pattern):
            layer = gather_params({n: t[c] for n, t in
                                   params["blocks"][k].items()})
            x, _ = block_apply(layer, x, mixer, ffn, cfg, positions,
                               enc_out=enc_out, impl=impl)
            x = shard_activation(x, "batch", "seq", "act_embed")
            x = grad_dtype_barrier(x)
        return x

    run = _maybe_remat(cfg)
    for c in range(n_cycles):
        x = run(cycle, x, c)
    for t in range(tail):
        mixer, ffn = cfg.pattern[t]
        x, _ = block_apply(gather_params(params["tail"][t]), x, mixer, ffn,
                           cfg, positions, enc_out=enc_out, impl=impl)
        # not in the reference (XLA keeps the batch split through the
        # tail); DTensor's strategies may gather it whole otherwise
        x = shard_activation(x, "batch", "seq", "act_embed")
    return rms_norm(x, gather_params(params["final_norm"]), cfg.norm_eps)


# products without batch dimensions: a (B, S, D) @ (D, F) projection is
# folded into one 2-d product, an attention einsum is a batched one (bmm)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(cfg: ModelConfig) -> Callable:
    """``run(fn, *args)`` for one cycle of the layer loop under
    ``cfg.remat`` (the reference's `_maybe_remat`): ``"none"`` calls it;
    ``"full"`` checkpoints it (`torch.utils.checkpoint`, non-reentrant);
    ``"dots"`` checkpoints it keeping the outputs of 2-d products
    (``aten.mm`` / ``aten.addmm``) and recomputing the rest.  Without
    autograd every mode is a plain call."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}; the port has none, full, "
                         f"dots")

    def run(fn, *args):
        if cfg.remat == "none" or not torch.is_grad_enabled():
            return fn(*args)
        if cfg.remat == "full":
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))
    return run


def _start(params: Params, batch, cfg: ModelConfig, impl: str):
    """Embedded tokens, their positions 0 .. S-1, and the encoder's output
    (None unless the model is an encoder-decoder)."""
    # batch and sequence only: the reference keeps the embed dim whole
    # here (an SPMD partitioner fault inside its microbatch loop)
    x = shard_activation(_embed_inputs(params, batch, cfg), "batch", "seq",
                         None)
    enc_out = _encode(params, batch, cfg, impl) if cfg.is_encdec else None
    return (x, torch.arange(x.shape[1], dtype=torch.int32, device=x.device),
            enc_out)


def _layers(tree: Params, cfg: ModelConfig):
    """((mixer, ffn), the layer's dict) of every layer in order — the
    cycles' pattern positions (views into the stacked leaves), then the
    tail — for the parameters or a cache alike."""
    n_cycles, tail = cfg.cycles_and_tail
    for c in range(n_cycles):
        for k, kind in enumerate(cfg.pattern):
            yield kind, {n: t[c] for n, t in tree["blocks"][k].items()}
    for t in range(tail):
        yield cfg.pattern[t], tree["tail"][t]


def logits_from_h(params: Params, h: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    """float32 logits (B, S, V_padded); the vocabulary padding is masked
    to -1e30."""
    logits = (h @ gather_params(params["unembed"]).to(h.dtype)).float()
    pad = cfg.padded_vocab - cfg.vocab_size
    if pad and isinstance(logits, DTensor):
        # DTensor (torch 2.11) has no `fill_` strategy: a select
        live = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(live < cfg.vocab_size, logits, NEG_INF)
    elif pad:
        logits[..., cfg.vocab_size:] = NEG_INF
    return logits


def _xent(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the masked token losses, number of valid tokens) of float32
    ``logits`` (..., V) against integer ``labels``.  On DTensor logits
    (pending sums reduced first) the gold logit is a one-hot select
    summed over the vocabulary, which may stay split: DTensor's gather
    from a split dim fails on the view after it, and its backward
    scatters into zeros of the global shape, whole on every rank.  The
    value is the gather's (one term and zeros)."""
    logits = unshard(logits)
    lse = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        hit = labels[..., None] == torch.arange(logits.shape[-1],
                                                device=labels.device)
        gold = torch.where(hit, logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return ((lse - gold) * valid).sum(), valid.sum()


def loss_fn(params: Params, batch, cfg: ModelConfig, *, impl: str = "jnp"
            ) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` (B, S) (the
    reference's `loss_fn`): position s predicts token s + 1.  With
    ``cfg.logit_chunk`` = C the (B, S - 1, V) logits never exist at once:
    chunks of C positions, each checkpointed (its logits recomputed in
    the backward), then the remainder.  ``impl`` as in `forward`; the
    default is the plain path, which autograd can differentiate (the
    kernels raise under autograd)."""
    h = forward(params, batch, cfg, impl=impl)
    tokens = torch.as_tensor(batch["tokens"], device=h.device)
    labels = shard_activation(tokens[:, 1:].long(), "batch", "seq")
    valid = torch.ones_like(labels, dtype=torch.float32)
    if not cfg.logit_chunk:
        tot, cnt = _xent(logits_from_h(params, h[:, :-1], cfg), labels,
                         valid)
        return tot / torch.clamp(cnt, min=1.0)
    C = cfg.logit_chunk
    n = labels.shape[1] // C

    def chunk(hh, ll, vv):
        return _xent(logits_from_h(params, hh, cfg), ll, vv)

    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        cut = slice(i * C, (i + 1) * C)
        s, c = checkpointed(chunk, h[:, cut], labels[:, cut], valid[:, cut])
        tot, cnt = tot + s, cnt + c
    if labels.shape[1] % C:
        s, c = chunk(h[:, n * C:-1], labels[:, n * C:], valid[:, n * C:])
        tot, cnt = tot + s, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------
def _block_cache_shape(cfg: ModelConfig, mixer: str, B: int, max_seq: int):
    """{name: (shape, dtype, logical axes)} of one layer's cache."""
    dt = torch_dtype(cfg.dtype)
    if mixer == "rglru":
        W = cfg.lru_width
        return {"state": ((B, W), torch.float32, ("cache_batch", "lru")),
                "conv": ((B, cfg.conv_width - 1, W), dt,
                         ("cache_batch", None, "lru"))}
    if mixer == "ssd":
        H = cfg.ssm_heads
        P = cfg.d_inner // H
        return {"state": ((B, H, P, cfg.ssm_state), torch.float32,
                          ("cache_batch", "ssm_heads", None, None)),
                "conv": ((B, cfg.conv_width - 1,
                          cfg.d_inner + 2 * cfg.ssm_state), dt,
                         ("cache_batch", None, "ssm_conv"))}
    W = attn_cache_len(mixer, cfg, max_seq)
    shape = (B, W, cfg.num_kv_heads, cfg.head_dim)
    cdt = torch_dtype(cfg.kv_cache_dtype)
    axes = ("cache_batch", "cache_seq", "cache_kv", None)
    return {"k": (shape, cdt, axes), "v": (shape, cdt, axes)}


def _cache_tree(cfg: ModelConfig, B: int, max_seq: int, make_leaf: Callable,
                index) -> Params:
    """The cache tree with ``make_leaf(shape, dtype, axes)`` for each
    leaf (``blocks`` stacked over the cycles, ``tail``, an
    encoder-decoder's ``enc_out``) and ``index`` as given."""
    n_cycles, tail = cfg.cycles_and_tail

    def layer(mixer, stack):
        return {name: make_leaf(stack + shp, dt, ("layers",) * len(stack)
                                + ax)
                for name, (shp, dt, ax) in _block_cache_shape(
                    cfg, mixer, B, max_seq).items()}

    cache = {"blocks": tuple(layer(mixer, (n_cycles,))
                             for mixer, _f in cfg.pattern),
             "tail": tuple(layer(cfg.pattern[t][0], ())
                           for t in range(tail)),
             "index": index}
    if cfg.is_encdec:
        cache["enc_out"] = make_leaf((B, cfg.encoder_seq, cfg.d_model),
                                     torch_dtype(cfg.dtype),
                                     ("cache_batch", None, "act_embed"))
    return cache


def init_cache(cfg: ModelConfig, B: int, max_seq: int,
               device: DeviceLike = None) -> Params:
    """A zero cache for ``B`` sequences of up to ``max_seq`` tokens on
    ``device``, in the reference's layout (``blocks`` stacked over the
    cycles, ``tail``, ``index`` = 0; an encoder-decoder's ``enc_out``
    (B, encoder_seq, D) in the compute dtype)."""
    dev = resolve_device(device)
    return _cache_tree(cfg, B, max_seq,
                       lambda shp, dt, _ax: zeros_of(shp, dt, dev), 0)


def cache_specs(cfg: ModelConfig, B: int, max_seq: int) -> Params:
    """The cache tree on the ``meta`` device (``index`` an int32 scalar, as
    the reference's): shapes and dtypes, nothing allocated."""
    def empty(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")
    return _cache_tree(cfg, B, max_seq, lambda shp, dt, _ax: empty(shp, dt),
                       empty((), torch.int32))


def cache_axes(cfg: ModelConfig, B: int, max_seq: int) -> Params:
    """The cache tree's logical axes (``index``: None, replicated)."""
    return _cache_tree(cfg, B, max_seq, lambda _shp, _dt, ax: ax, None)


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------
def prefill(params: Params, batch, cfg: ModelConfig, max_seq: int, *,
            impl: str = "pallas") -> Tuple[Params, torch.Tensor]:
    """Run the whole prompt and build the cache.  Returns ``(cache,
    logits of the last position (B, 1, V_padded))``; ``impl`` as in
    `forward`.  An encoder-decoder's cache carries the encoder's output
    as ``enc_out``."""
    x, positions, enc_out = _start(params, batch, cfg, impl)
    n_cycles, _tail = cfg.cycles_and_tail
    P = len(cfg.pattern)
    caches = []
    for (mixer, ffn), layer in _layers(params, cfg):
        x, c = block_apply(gather_params(layer), x, mixer, ffn, cfg,
                           positions,
                           enc_out=enc_out, impl=impl, want_cache=True,
                           max_seq=max_seq)
        # a DTensor cache on its logical axes (no pending sum), which
        # decode's in-place writes keep
        axes = _block_cache_shape(cfg, mixer, x.shape[0], max_seq)
        caches.append({n: shard_activation(t, *axes[n][2])
                       for n, t in c.items()})
    blocks = tuple({name: torch.stack([caches[c * P + k][name]
                                       for c in range(n_cycles)])
                    for name in caches[k]}
                   for k in range(P)) if n_cycles else ()
    h = rms_norm(x, gather_params(params["final_norm"]), cfg.norm_eps)
    logits = logits_from_h(params, h[:, -1:], cfg)
    cache = {"blocks": blocks, "tail": tuple(caches[n_cycles * P:]),
             "index": x.shape[1]}
    if enc_out is not None:
        cache["enc_out"] = enc_out
    return cache, logits


def decode_step(params: Params, tokens, cache: Params, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Params]:
    """One new token per sequence.  ``tokens`` (B, 1) -> ``(logits (B, 1,
    V_padded), cache)``.

    Unlike the reference, which returns a new cache, this updates the
    cache in place — the K/V rows are written into their ring slots and
    the SSD and RG-LRU states and conv windows overwritten — and returns
    it with ``index`` advanced: a cache decoded from no longer holds the
    state it had before the call."""
    table = gather_params(params["embed"])
    tok = torch.as_tensor(tokens, device=table.device).long()
    x = shard_activation(F.embedding(tok, table).to(torch_dtype(cfg.dtype)),
                         "batch", None, "act_embed")
    index = int(cache["index"])
    enc_out = cache.get("enc_out")
    for ((mixer, ffn), layer), (_kind, views) in zip(_layers(params, cfg),
                                                     _layers(cache, cfg)):
        x, new = block_decode(gather_params(layer), x, views, mixer, ffn,
                              cfg, index, enc_out=enc_out)
        for name, t in new.items():       # recurrent states, conv windows
            if t is not views[name]:
                views[name].copy_(t)
    h = rms_norm(x, gather_params(params["final_norm"]), cfg.norm_eps)
    logits = logits_from_h(params, h, cfg)
    return logits, dict(cache, index=index + 1)
