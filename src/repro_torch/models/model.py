"""Unified LM assembly for every registered architecture family.

Functional: ``init_params(cfg, gen)`` builds the parameter tree;
``forward`` runs a prefill (or a whole sequence); ``decode_step`` runs
one cached token. Layer stacks carry a leading L axis, as the
reference's do, so the two trees line up.

Families:
  dense / vlm / audio : pre-norm attention + gated MLP
  moe                 : first_dense_layers dense, then MoE (SAM dispatch)
  ssm (xlstm)         : mLSTM blocks with sLSTM at cfg.slstm_layers
  hybrid (zamba2)     : mamba2 stack; ONE shared attention+MLP block
                        applied every cfg.attn_every layers (weight reuse)

A port of ``repro.models.model``'s serving half for one device. The
reference's ``lax.scan`` over a stack is a loop over its L axis, each
layer's cache sliced from the stacked caches and the new ones stacked
back. ``cfg.unroll_scan`` unrolls the reference's scan for its roofline
probes; an eager loop has nothing to unroll, so the port ignores it.
A stack's layers are taken with one ``torch.unbind`` a tensor, so that
under autograd the backward pass of a stack is one ``torch.stack`` (a
slice a layer would add a zero tensor the size of the whole stack to
the gradient, once a layer). ``loss_fn`` is the reference's: the
token-mean cross entropy of ``forward``'s logits. ``remat`` checkpoints
each layer of the stacks the reference checkpoints (the dense, vlm,
audio and both moe stacks, zamba2's mamba layers; not xlstm's loop, and
never when caches are passed) with
``torch.utils.checkpoint.checkpoint``: ``"full"`` saves nothing of a
layer (``nothing_saveable``), ``"dots"`` saves the outputs of the
projections (``aten.mm``/``aten.addmm``, the products without batch
dims: ``dots_with_no_batch_dims_saveable``) and recomputes everything
else. Activation sharding is the reference's: ``shard_activation`` on
the embeddings, on each layer's output and on the logits
(``distributed.sharding``), which redistributes DTensor activations of
parameters placed over a process group's mesh and changes nothing
without a policy or on plain tensors. Placed parameters are gathered
where they are used (each stack a layer at a time, inside the layer's
checkpoint under remat): a transformer layer's attention (MLA's too)
and MLP, the embedding and the head over the data group only, so their
products are split over the model axis by the reference's sharding
rules (``distributed.sharding``; a row-parallel product's partial sum
is reduced before the residual add); a MoE block's experts not at all
(each card keeps its expert-parallel shard and the dispatch moves the
tokens to it, ``models.moe``), its router and shared experts over the
data group; mamba2, xlstm and zamba2's shared block whole, so their
activations are sharded over the batch only. ``forward`` runs inside
``spmd_region``, so the plain tensors it builds meet DTensors as
replicated ones. Token ids outside the vocabulary raise ``ValueError``
where the reference's gather would clamp them.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as ckpt

from ..configs.base import ModelConfig
from ..core import coord_ops as co
from torch.distributed.tensor import Partial
from torch.distributed.tensor.experimental import local_map

from ..distributed import sharding as shd
from ..distributed.sharding import (gathered, gathered_but_experts,
                                    gathered_over_data, reduced,
                                    shard_activation, spmd_region)
from .attention import attention, init_attention, init_kv_cache
from .common import (apply_mlp, cross_entropy, dense_init, device_of,
                     init_embedding, init_mlp, init_rms, rms_norm)
from .mamba2 import init_mamba2, init_mamba2_cache, mamba2
from .mla import init_mla, init_mla_cache, mla_attention
from .moe import apply_moe, init_moe
from .xlstm import (init_mlstm, init_mlstm_cache, init_slstm,
                    init_slstm_cache, mlstm, slstm)

__all__ = ["init_params", "embed_inputs", "forward", "init_caches",
           "loss_fn", "decode_step", "REMAT_POLICIES", "tree_map",
           "tree_stack",
           "tree_leaves", "tree_unflatten", "tree_unzip"]


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensors of nested dicts and lists (and of the trees
    of the same structure in ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of nested dicts, lists and tuples in ``jax.tree.leaves``'
    order: a dict's keys sorted, lists and tuples in order; None holds no
    leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` in place of its own, in
    ``tree_leaves``' order."""
    return _unflatten(tree, iter(leaves))


def _unflatten(t, it):
    # a module-level recursion: a nested one would keep ``it``, and so the
    # leaves, in a reference cycle until the garbage collector runs
    if isinstance(t, dict):
        out = {k: _unflatten(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_unflatten(v, it) for v in t)
    return None if t is None else next(it)


def tree_unzip(tree, n: int) -> list:
    """``n`` trees from one whose leaves are ``n``-tuples (what
    ``tree_map`` of a function that returns a tuple leaves)."""
    return [_pick(tree, i) for i in range(n)]


def _pick(t, i: int):
    if isinstance(t, dict):
        return {k: _pick(v, i) for k, v in t.items()}
    if isinstance(t, list):
        return [_pick(v, i) for v in t]
    return t[i]


def tree_stack(trees):
    """A list of trees of one structure as one tree, each tensor stacked
    on a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _unstack(tree, n: int) -> list:
    """The ``n`` trees along a stacked tree's leading axis, each tensor
    split by one ``torch.unbind``."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [_unstack(v, n) for v in tree]
        return [[v[i] for v in parts] for i in range(n)]
    return list(torch.unbind(tree))


def _stack_len(stack) -> int:
    while isinstance(stack, (dict, list)):
        stack = next(iter(stack.values())) if isinstance(stack, dict) \
            else stack[0]
    return stack.shape[0]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _stacked(init_fn, gen, n: int):
    """``n`` layers from ``init_fn``, stacked on a leading layer axis; for
    ``n == 0`` the empty stack of one layer's shapes. One layer is its
    tensors with the axis added, not copied (a copy would hold a layer
    twice: deepseek-v3-671b's MoE layer alone is 45 GB in float32)."""
    if n == 1:
        return tree_map(lambda t: t.unsqueeze(0), init_fn(gen))
    if n:
        return tree_stack([init_fn(gen) for _ in range(n)])
    dev = device_of(gen)
    return tree_map(lambda t: torch.empty((0,) + tuple(t.shape),
                                          dtype=t.dtype, device=dev),
                    init_fn(None))


def _init_tf_layer(cfg: ModelConfig, moe: bool):
    def f(gen):
        dev = device_of(gen)
        p = {"ln1": init_rms(cfg.d_model, cfg.pdtype, dev),
             "ln2": init_rms(cfg.d_model, cfg.pdtype, dev)}
        if cfg.use_mla:
            p["attn"] = init_mla(
                gen, cfg.d_model, cfg.n_heads, q_lora_rank=cfg.q_lora_rank,
                kv_lora_rank=cfg.kv_lora_rank, qk_nope_dim=cfg.qk_nope_dim,
                rope_dim=cfg.rope_dim, v_head_dim=cfg.v_head_dim,
                dtype=cfg.pdtype)
        else:
            p["attn"] = init_attention(
                gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.resolved_head_dim, cfg.pdtype, qk_norm=cfg.qk_norm)
        if moe:
            p["moe"] = init_moe(gen, cfg.d_model, cfg.moe_d_ff,
                                cfg.n_experts, cfg.n_shared_experts,
                                cfg.n_shared_experts * cfg.moe_d_ff or None,
                                dtype=cfg.pdtype)
        else:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.pdtype)
        return p
    return f


def init_params(cfg: ModelConfig,
                gen: Optional[torch.Generator]) -> Dict[str, Any]:
    """The parameter tree of ``cfg``, drawn from ``gen`` on its device, in
    ``cfg.pdtype`` (the reference's tree: same paths, shapes, dtypes);
    ``gen=None`` gives the tree's meta tensors (shapes only)."""
    dev = device_of(gen)
    p: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, cfg.pdtype),
        "ln_f": init_rms(cfg.d_model, cfg.pdtype, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, cfg.pdtype)

    if cfg.family in ("dense", "vlm", "audio"):
        p["layers"] = _stacked(_init_tf_layer(cfg, False), gen, cfg.n_layers)
    elif cfg.family == "moe":
        nd = cfg.first_dense_layers
        if nd:
            p["dense_layers"] = _stacked(_init_tf_layer(cfg, False), gen, nd)
        p["layers"] = _stacked(_init_tf_layer(cfg, True), gen,
                               cfg.n_layers - nd)
    elif cfg.family == "ssm":
        def init_m(g):
            return {"ln": init_rms(cfg.d_model, cfg.pdtype, device_of(g)),
                    "cell": init_mlstm(g, cfg.d_model, cfg.n_heads,
                                       dtype=cfg.pdtype)}
        mpos = [i for i in range(cfg.n_layers) if i not in cfg.slstm_layers]
        p["mlstm_layers"] = _stacked(init_m, gen, len(mpos))
        p["slstm_layers"] = [
            {"ln": init_rms(cfg.d_model, cfg.pdtype, dev),
             "cell": init_slstm(gen, cfg.d_model, cfg.n_heads, cfg.pdtype)}
            for _ in cfg.slstm_layers]
    elif cfg.family == "hybrid":
        def init_mb(g):
            return {"ln": init_rms(cfg.d_model, cfg.pdtype, device_of(g)),
                    "cell": init_mamba2(g, cfg.d_model,
                                        expand=cfg.ssm_expand,
                                        headdim=cfg.ssm_headdim,
                                        d_state=cfg.ssm_state,
                                        dtype=cfg.pdtype)}
        p["mamba_layers"] = _stacked(init_mb, gen, cfg.n_layers)
        p["shared_attn"] = _init_tf_layer(cfg, False)(gen)
    else:
        raise ValueError(cfg.family)

    if cfg.frontend == "siglip_stub":
        p["patch_proj"] = dense_init(gen, cfg.patch_dim, cfg.d_model,
                                     cfg.pdtype)
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _tf_layer(cfg: ModelConfig, p, x, moe: bool, cache=None, prefix_len=None):
    gelu = cfg.activation == "gelu"
    h = rms_norm(x, p["ln1"], add_unit_offset=gelu)
    if cfg.use_mla:
        a, new_cache = mla_attention(
            p["attn"], h, n_heads=cfg.n_heads, qk_nope_dim=cfg.qk_nope_dim,
            rope_dim=cfg.rope_dim, v_head_dim=cfg.v_head_dim,
            kv_lora_rank=cfg.kv_lora_rank, rope_theta=cfg.rope_theta,
            compute_dtype=cfg.cdtype, cache=cache)
    else:
        a, new_cache = attention(
            p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            qk_norm=cfg.qk_norm, window=cfg.window, prefix_len=prefix_len,
            compute_dtype=cfg.cdtype, cache=cache, soft_cap=cfg.soft_cap)
    # a row-parallel product ends in a float32 partial sum over the model
    # axis, reduced here (one all-reduce for attention, one for the MLP)
    x = x + reduced(a).to(x.dtype)
    h = rms_norm(x, p["ln2"], add_unit_offset=gelu)
    if moe:
        m = apply_moe(p["moe"], h, k=cfg.top_k, dispatch=cfg.moe_dispatch,
                      compute_dtype=cfg.cdtype)
    else:
        m = apply_mlp(p["mlp"], h, activation=cfg.activation,
                      compute_dtype=cfg.cdtype)
    return x + reduced(m).to(x.dtype), new_cache


def _tf_gather(lp):
    """A transformer layer's placed parameters where it runs: attention
    (MLA's too) and the MLP gathered over the data group only, so their
    products split over the model axis; the MoE block by
    ``sharding.gathered_but_experts`` (the experts not at all, the router
    and the shared experts over the data group); the norms whole."""
    return {k: gathered_but_experts(v) if k == "moe" else
            gathered_over_data(v) if k in ("attn", "mlp") else
            gathered(v) for k, v in lp.items()}


def _dots_saveable(ctx, op, *args, **kwargs):
    """Save the projections' outputs (2-D products: ``mm``, ``addmm``);
    recompute everything else, the batched score products included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


# policy name -> the ``context_fn`` of its per-layer checkpoint (None: the
# default context, which saves nothing of the layer); "none" checkpoints
# nothing
_REMAT_CONTEXTS = {
    "full": None,
    "dots": functools.partial(ckpt.create_selective_checkpoint_contexts,
                              _dots_saveable),
}
REMAT_POLICIES = ("none",) + tuple(_REMAT_CONTEXTS)


def _remat(name) -> Optional[Callable]:
    """The per-layer checkpoint of policy ``name`` as a function of the
    layer's function, or None for no checkpoint; ``ValueError`` for a name
    not in ``REMAT_POLICIES``."""
    if name in (None, "none"):
        return None
    if name not in _REMAT_CONTEXTS:
        raise ValueError(name)
    context_fn = _REMAT_CONTEXTS[name]
    kw = {} if context_fn is None else {"context_fn": context_fn}

    def wrap(fn):
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 **kw)
    return wrap


def _scan_stack(stack, x, layer_fn, caches=None, remat=None,
                gather=gathered):
    """``layer_fn`` over a stacked layer tree, layer by layer, with each
    layer's slice of the stacked caches; returns (x, the new caches
    stacked, or None without caches). ``remat`` (a wrapper from
    ``_remat``) checkpoints each layer when there are no caches.
    ``gather`` gathers a layer's placed parameters where it runs."""
    n = _stack_len(stack)
    layers = _unstack(stack, n)
    if caches is None:
        def body(lp, h):
            return shard_activation(layer_fn(gather(lp), h, None)[0])
        if remat is not None:
            body = remat(body)
        for lp in layers:
            x = body(lp, x)
        return x, None
    new_caches = []
    for lp, c in zip(layers, _unstack(caches, n)):
        x, c2 = layer_fn(gather(lp), x, c)
        x = shard_activation(x)
        new_caches.append(c2)
    return x, (tree_stack(new_caches) if n else caches)


def _check_tokens(cfg: ModelConfig, tokens: torch.Tensor) -> None:
    if isinstance(tokens, DTensor):      # every process checks them all
        tokens = tokens.full_tensor()
    if tokens.device.type == "meta":     # no ids to read (the dry-run)
        return
    lo, hi = (int(v) for v in torch.aminmax(tokens))
    if lo < 0 or hi >= cfg.vocab:
        raise ValueError(f"token ids must lie in [0, {cfg.vocab}); got "
                         f"[{lo}, {hi}]")


def _lookup(ids, emb):
    """``emb[ids]``. A table placed with its vocabulary split over the model
    axis is looked up vocab-parallel, as Megatron does: each shard reads
    the ids in its rows and zeros the rest, leaving a ``Partial`` sum over
    the model axis (torch's embedding op on such a DTensor has no
    backward: DTensor cannot turn the gradient's partial sum into its
    masked one). Any other placed table is made whole over the model axis
    and read by torch's embedding op, whose backward DTensor carries (the
    index form's, ``index_put``, fails on torch 2.11 with the ids sharded
    over the batch)."""
    if not isinstance(emb, DTensor):
        return emb[ids]
    if not shd.model_sharded(emb, 0):
        return F.embedding(ids, shd.whole_over_model(emb))
    rank, size = shd.model_coordinate(emb)
    rows = emb.shape[0] // size

    def local(i, table):
        j = i - rank * rows
        hit = (j >= 0) & (j < rows)
        out = F.embedding(torch.where(hit, j, torch.zeros_like(j)), table)
        return out.masked_fill(~hit[..., None], 0)
    grad_pl = [Partial() if p.is_replicate() else p
               for p in emb.placements]
    return local_map(
        local, out_placements=(shd.over_model(ids, Partial()),),
        in_placements=(ids.placements, emb.placements),
        in_grad_placements=(ids.placements, grad_pl),
        device_mesh=emb.device_mesh)(ids, emb)


def embed_inputs(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """Token/frame/patch embedding (modality stubs live here)."""
    cd = cfg.cdtype
    if cfg.frontend == "encodec_stub":
        x = batch["frames"].to(cd)                # (B, S, D) precomputed
        prefix_len = None
    else:
        tokens = batch["tokens"]
        _check_tokens(cfg, tokens)
        x = _lookup(tokens.long(), params["embed"]).to(cd)
        # a vocab-parallel lookup's partial sum, reduced (one all-reduce)
        x = reduced(x)
        prefix_len = None
        if cfg.frontend == "siglip_stub":
            patches = (batch["patches"].to(cd)
                       @ params["patch_proj"].to(cd))
            x = torch.cat([patches, x], dim=1)
            prefix_len = cfg.n_patches
    if cfg.family in ("dense", "vlm") and cfg.activation == "gelu":
        # gemma scaling by sqrt(d_model), rounded to the compute dtype
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cd, device=x.device)
    return x, prefix_len


# the stacks that ``_scan_stack`` runs, whose layers it gathers one by one
_GATHERED_BY_LAYER = ("layers", "dense_layers", "mamba_layers")
# the leaves split over the model axis where they are used: the
# vocab-parallel embedding and the column-parallel head
_SPLIT_TOP = ("embed", "lm_head")


def forward(cfg: ModelConfig, params, batch, caches=None, remat=None
            ) -> Tuple[torch.Tensor, Any]:
    """Returns (logits (B, S, V), new caches or None). ``remat``: None or
    ``"none"``, ``"dots"`` or ``"full"`` (see the module's docstring)."""
    with spmd_region(params):
        return _forward(cfg, params, batch, caches, _remat(remat))


def _forward(cfg: ModelConfig, params, batch, caches, remat):
    # placed parameters are gathered where they are used: the stacks a
    # layer at a time (in ``_scan_stack``), the rest here
    params = {k: v if k in _GATHERED_BY_LAYER else
              gathered_over_data(v) if k in _SPLIT_TOP else gathered(v)
              for k, v in params.items()}
    x, prefix_len = embed_inputs(cfg, params, batch)
    x = shard_activation(x)
    new_caches: Dict[str, Any] = {}

    if cfg.family in ("dense", "vlm", "audio"):
        def fn(lp, h, c):
            return _tf_layer(cfg, lp, h, False, c, prefix_len)
        x, nc = _scan_stack(params["layers"], x, fn,
                            caches["layers"] if caches else None, remat,
                            _tf_gather)
        new_caches["layers"] = nc
    elif cfg.family == "moe":
        if "dense_layers" in params:
            def fn(lp, h, c):
                return _tf_layer(cfg, lp, h, False, c)
            x, nc = _scan_stack(params["dense_layers"], x, fn,
                                caches["dense_layers"] if caches else None,
                                remat, _tf_gather)
            new_caches["dense_layers"] = nc

        def fn_moe(lp, h, c):
            return _tf_layer(cfg, lp, h, True, c)
        x, nc = _scan_stack(params["layers"], x, fn_moe,
                            caches["layers"] if caches else None, remat,
                            _tf_gather)
        new_caches["layers"] = nc
    elif cfg.family == "ssm":
        x, new_caches = _ssm_forward(cfg, params, x, caches)
    elif cfg.family == "hybrid":
        x, new_caches = _hybrid_forward(cfg, params, x, caches, remat)

    x = rms_norm(x, params["ln_f"],
                 add_unit_offset=(cfg.activation == "gelu"))
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.cdtype)
    x = x.to(cfg.cdtype)
    if shd.model_sharded(head, 1):      # column-parallel logits
        x = shd.model_input(x)
    logits = shard_activation(x @ head, "logits")
    if cfg.frontend == "siglip_stub":
        logits = logits[:, cfg.n_patches:]        # text positions only
    return logits, (new_caches if caches is not None else None)


def _ssm_forward(cfg, params, x, caches):
    new_caches = {"mlstm": [], "slstm": []}
    n_m = _stack_len(params["mlstm_layers"])
    m_params = _unstack(params["mlstm_layers"], n_m)
    m_caches = _unstack(caches["mlstm"], n_m) if caches else None
    mi = si = 0
    for i in range(cfg.n_layers):
        if i in cfg.slstm_layers:
            p = params["slstm_layers"][si]
            c = caches["slstm"][si] if caches else None
            h = rms_norm(x, p["ln"])
            y, c2 = slstm(p["cell"], h, n_heads=cfg.n_heads,
                          compute_dtype=cfg.cdtype, cache=c)
            new_caches["slstm"].append(c2)
            si += 1
        else:
            p = m_params[mi]
            c = m_caches[mi] if caches else None
            h = rms_norm(x, p["ln"])
            y, c2 = mlstm(p["cell"], h, n_heads=cfg.n_heads,
                          chunk=cfg.ssm_chunk, compute_dtype=cfg.cdtype,
                          cache=c)
            new_caches["mlstm"].append(c2)
            mi += 1
        # each layer's output split over the batch only, as a scanned
        # stack's is (DTensor would carry a layer's own layout onward)
        x = shard_activation(x + y.to(x.dtype))
    if caches is not None and new_caches["mlstm"]:
        new_caches["mlstm"] = tree_stack(new_caches["mlstm"])
    return x, new_caches


def _hybrid_forward(cfg, params, x, caches, remat=None):
    """Zamba2: groups of attn_every mamba layers + the shared attn block."""
    g = cfg.attn_every
    n_groups = cfg.n_layers // g
    groups = _unstack(tree_map(
        lambda a: a.reshape((n_groups, g) + a.shape[1:]),
        params["mamba_layers"]), n_groups)
    new_caches = {"mamba": [], "attn": []}

    def mamba_layer(lp, h, c):
        hh = rms_norm(h, lp["ln"])
        y, c2 = mamba2(lp["cell"], hh, expand=cfg.ssm_expand,
                       headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
                       chunk=cfg.ssm_chunk, compute_dtype=cfg.cdtype,
                       cache=c)
        return h + y.to(h.dtype), c2

    for gi in range(n_groups):
        c = caches["mamba"][gi] if caches else None
        x, c2 = _scan_stack(groups[gi], x, mamba_layer, c, remat)
        new_caches["mamba"].append(c2)
        ac = caches["attn"][gi] if caches else None
        x, ac2 = _tf_layer(cfg, params["shared_attn"], x, False, ac)
        x = shard_activation(x)
        new_caches["attn"].append(ac2)
    return x, new_caches


# ---------------------------------------------------------------------------
# caches + decode
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Zeroed caches of every layer for ``batch`` rows of up to
    ``max_seq`` tokens, on ``device`` (CUDA unless the caller names one);
    K/V and conv windows in ``dtype``, recurrent states in float32."""
    dev = co.resolve_device(device)
    if cfg.family in ("dense", "vlm", "audio", "moe"):
        if cfg.use_mla:
            def one():
                return init_mla_cache(batch, max_seq, cfg.kv_lora_rank,
                                      cfg.rope_dim, dtype, device=dev)
        else:
            def one():
                return init_kv_cache(batch, max_seq, cfg.n_kv_heads,
                                     cfg.resolved_head_dim, dtype,
                                     device=dev)

        def stack(n):
            if n:
                return tree_stack([one() for _ in range(n)])
            return tree_map(lambda t: t[None][:0], one())
        out = {}
        if cfg.family == "moe" and cfg.first_dense_layers:
            out["dense_layers"] = stack(cfg.first_dense_layers)
            out["layers"] = stack(cfg.n_layers - cfg.first_dense_layers)
        else:
            out["layers"] = stack(cfg.n_layers)
        return out
    if cfg.family == "ssm":
        n_m = cfg.n_layers - len(cfg.slstm_layers)
        return {
            "mlstm": tree_stack(
                [init_mlstm_cache(batch, cfg.d_model, cfg.n_heads,
                                  device=dev) for _ in range(n_m)]),
            "slstm": [init_slstm_cache(batch, cfg.d_model, cfg.n_heads,
                                       device=dev)
                      for _ in range(len(cfg.slstm_layers))],
        }
    if cfg.family == "hybrid":
        g = cfg.attn_every
        n_groups = cfg.n_layers // g

        def mk():
            return init_mamba2_cache(batch, cfg.d_model,
                                     expand=cfg.ssm_expand,
                                     headdim=cfg.ssm_headdim,
                                     d_state=cfg.ssm_state, dtype=dtype,
                                     device=dev)
        return {
            "mamba": [tree_stack([mk() for _ in range(g)])
                      for _ in range(n_groups)],
            "attn": [init_kv_cache(batch, max_seq, cfg.n_kv_heads,
                                   cfg.resolved_head_dim, dtype, device=dev)
                     for _ in range(n_groups)],
        }
    raise ValueError(cfg.family)


def loss_fn(cfg: ModelConfig, params, batch, remat=None) -> torch.Tensor:
    """The token-mean cross entropy of ``forward``'s logits against
    ``batch["labels"]`` (over ``batch["mask"]`` where given), float32."""
    logits, _ = forward(cfg, params, batch, remat=remat)
    return cross_entropy(logits, batch["labels"], batch.get("mask"))


def decode_step(cfg: ModelConfig, params, caches, batch):
    """One new token against the KV/state caches. Returns (logits (B, V),
    caches)."""
    logits, new_caches = forward(cfg, params, batch, caches)
    return logits[:, -1], new_caches
