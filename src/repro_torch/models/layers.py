"""Neural-net building blocks (port of ``repro.models.layers``).

Plain functions on tensors.  Attention comes in two plain versions:

  * ``naive_attention``: materializes the (Sq, Sk) score matrix; used for
    short sequences and as the test oracle;
  * ``chunked_attention``: online softmax over KV chunks, O(S) memory.

On a CUDA tensor ``chunked_attention`` launches the hand-written
flash-attention kernel for every sequence length (the kernel masks the
ragged tail itself) or raises: it never runs the plain versions on the
card.  On the CPU it takes the reference's CPU branches.  Scores are
taken in float32 whatever the input dtype, as the reference's
``preferred_element_type=jnp.float32`` einsums take them.

``kernels_allowed``/``no_kernels`` keep the reference's names and its
thread-local flag.  A CPU tensor takes the plain version whatever the
flag; on a CUDA tensor inside ``no_kernels()``, ``chunked_attention``
and ``models.ssm.ssm_apply`` raise, since the card has no plain path.
The reference's ``loss`` enters ``no_kernels()`` because its Pallas
kernels have no VJP; the port's ``loss`` does not: its SSD scan and its
flash attention carry their own backward kernels
(``kernels.ssd_scan.ops.SSDScan``,
``kernels.flash_attention.ops.FlashAttention``).

Under a mesh the models run on DTensor parameters and activations.  A
tensor made from scratch (positions, masks) joins them as a replicated
DTensor (:func:`replicated_like`), and attention runs on each device's
own heads (:func:`heads_local`, ``local_map``): the kernel, or on the
CPU the plain version, sees plain local shards.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

_NEG = -1e30

_tls = threading.local()


def kernels_allowed() -> bool:
    return getattr(_tls, "kernels_ok", True)


@contextlib.contextmanager
def no_kernels():
    prev = getattr(_tls, "kernels_ok", True)
    _tls.kernels_ok = False
    try:
        yield
    finally:
        _tls.kernels_ok = prev


def require_kernels(caller: str) -> None:
    """Raise inside ``no_kernels()``: a CUDA tensor has only its kernel."""
    if not kernels_allowed():
        raise RuntimeError(f"{caller}: a CUDA tensor inside no_kernels(); "
                           f"the card has no plain path")


# --------------------------------------------------------------------------
# DTensor helpers (a mesh run); plain tensors pass through
# --------------------------------------------------------------------------

def replicated_like(t: torch.Tensor, x) -> torch.Tensor:
    """``t``, made from scratch on ``x``'s device, as a replicated DTensor
    on ``x``'s mesh when ``x`` is a DTensor; else ``t`` itself."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return t


def heads_local(fn, args, in_dims, out_dims):
    """``fn(*args)`` on each device's own shards, under ``local_map``.

    ``in_dims[i]`` places ``args[i]``: ``None`` for a plain value, else a
    pair (the dim split on the ``"model"`` axis or ``None`` for
    replicated there, whether dim 0 is the batch).  A batch dim keeps the
    first argument's dim-0 sharding on the other axes; everything else is
    replicated on them.  ``fn`` returns a tuple, and ``out_dims`` places
    its items the same way; the call returns them as DTensors.

    A gradient into a replicated input is each device's share of it, a
    ``Partial`` sum: on the model axis where other inputs split their
    heads there, on a batch axis for an input without a batch dim.
    """
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    lead = args[0]
    mesh = lead.device_mesh
    heads_split = any(d is not None and d[0] is not None for d in in_dims)

    def plc(dims, grad=False):
        if dims is None:
            return None
        dim, batched = dims
        out = []
        for i, name in enumerate(mesh.mesh_dim_names):
            split = mesh.size(i) > 1
            if name == "model":
                if dim is not None and split:
                    out.append(Shard(dim))
                elif grad and heads_split and split:
                    out.append(Partial())
                else:
                    out.append(Replicate())
            elif lead.placements[i] == Shard(0):
                out.append(Shard(0) if batched
                           else Partial() if grad else Replicate())
            else:
                out.append(Replicate())
        return out

    wrapped = local_map(
        fn, out_placements=tuple(plc(d) for d in out_dims),
        in_placements=tuple(plc(d) for d in in_dims),
        in_grad_placements=tuple(plc(d, grad=True) for d in in_dims),
        device_mesh=mesh, redistribute_inputs=True)
    return wrapped(*args)


def whole_on_model(x):
    """DTensor ``x`` replicated on the ``"model"`` axis (its other
    placements kept)."""
    mesh = x.device_mesh
    return x.redistribute(mesh, [
        Replicate() if name == "model" else pl
        for name, pl in zip(mesh.mesh_dim_names, x.placements)])


def split_heads(t, shape):
    """``t.reshape(shape)``, shape (..., heads, head_dim): a DTensor split
    on the model axis is gathered whole there first where the heads do
    not divide that axis (a DTensor cannot split such a dim unevenly)."""
    if isinstance(t, DTensor) and shape[-2] % model_axis_size(t):
        t = whole_on_model(t)
    return t.reshape(shape)


def embed(table, tokens):
    """Rows ``tokens`` of ``table`` (an index).  On DTensors each device
    looks up its own rows (``local_map``): with the vocab split on the
    model axis, a token outside the device's rows gives zeros and the
    rows are summed over that axis (a vocab-parallel embedding: one
    all-reduce)."""
    if not isinstance(table, DTensor):
        return table[tokens.long()]
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    m = names.index("model") if "model" in names else None
    split = m is not None and table.placements[m] == Shard(0)
    lo = mesh.get_local_rank(m) * (table.shape[0] // mesh.size(m)) \
        if split else 0

    def local(tab, tok):
        if not split:
            return tab[tok.long()]
        t = tok.long() - lo
        hit = (t >= 0) & (t < tab.shape[0])
        return tab[torch.where(hit, t, 0)] * hit[..., None]

    batch = [Shard(0) if tokens.placements[i] == Shard(0) else Replicate()
             for i in range(mesh.ndim)]
    tab_pl = [Shard(0) if i == m and split else Replicate()
              for i in range(mesh.ndim)]
    tab_grad = [Shard(0) if i == m and split
                else Partial() if batch[i] == Shard(0) else Replicate()
                for i in range(mesh.ndim)]
    out_pl = [Partial() if i == m and split else batch[i]
              for i in range(mesh.ndim)]
    out = local_map(local, out_placements=out_pl,
                    in_placements=(tab_pl, batch),
                    in_grad_placements=(tab_grad, batch),
                    device_mesh=mesh, redistribute_inputs=True)(
                        table, tokens)
    return out.redistribute(mesh, batch) if split else out


def write_position(cache, at, x) -> None:
    """``cache.index_copy_(1, at, x)``: x (B, 1, ...) into the cache
    (B, Smax, ...) at position ``at`` (a 1-element index tensor), in
    place.  A DTensor cache is written on each device's own shard
    (``local_map``); where the positions are split, the device holding
    ``at`` writes it and the others keep their rows."""
    if not isinstance(cache, DTensor):
        cache.index_copy_(1, at, x)
        return
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.distributed.tensor.experimental import local_map

    mesh, plc = cache.device_mesh, list(cache.placements)
    rows, (_, lo, *_) = compute_local_shape_and_global_offset(
        cache.shape, mesh, plc)
    rows = rows[1]
    x_plc = [Replicate() if p == Shard(1) else p for p in plc]

    def local(c, x, at):
        if rows == cache.shape[1]:
            c.index_copy_(1, at, x)
        else:
            t = at - lo
            mine = (t >= 0) & (t < rows)
            t = torch.clamp(t, 0, rows - 1)
            c.index_copy_(1, t, torch.where(mine, x, c.index_select(1, t)))
        return (c,)

    local_map(local, out_placements=(plc,),
              in_placements=(plc, x_plc, None), device_mesh=mesh,
              redistribute_inputs=True)(cache, x, at)


def merge_heads(o, w):
    """``o`` (..., heads, head_dim) with its last two dims merged, times
    the output projection ``w``.  Under a mesh, where the heads do not
    divide the model axis (they ran whole on every device), ``w`` is
    gathered whole there first, so the gradient into ``o`` comes back
    whole as well (a DTensor cannot split the heads dim unevenly)."""
    if isinstance(o, DTensor) and o.shape[-2] % model_axis_size(o):
        w = whole_on_model(w)
    return o.reshape(*o.shape[:-2], -1) @ w


def model_axis_size(x) -> int:
    """The size of ``x``'s mesh's ``"model"`` axis (1 for a plain
    tensor)."""
    if not isinstance(x, DTensor):
        return 1
    names = x.device_mesh.mesh_dim_names
    return x.device_mesh.size(names.index("model")) if "model" in names \
        else 1


# --------------------------------------------------------------------------
# initialization helpers (torch.Generator draws: other numbers than the
# reference's jax.random for the same seed)
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype) -> torch.Tensor:
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm(x, w, eps: float = 1e-5):
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * inv * w).to(x.dtype)


def layernorm(x, w, b, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w + b).to(x.dtype)


def apply_norm(cfg, x, p):
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"])
    return rmsnorm(x, p["w"])


def norm_init(cfg, d: int, device):
    ones = torch.ones((d,), dtype=torch.float32, device=device)
    if cfg.norm == "layernorm":
        return {"w": ones, "b": torch.zeros_like(ones)}
    return {"w": ones}


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope(x, positions, theta: float, frac: float = 1.0):
    """RoPE on x (..., S, H, hd) at positions (..., S).

    ``frac`` rotates only the first frac * hd dims (chatglm 0.5, stablelm
    0.25); the rest pass through.
    """
    hd = x.shape[-1]
    rot = int(hd * frac)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs               # (..., S, half)
    cos = replicated_like(torch.cos(ang)[..., None, :], x)   # (..., S, 1, half)
    sin = replicated_like(torch.sin(ang)[..., None, :], x)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    out = torch.cat([y1, y2], dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < hd else out


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _mask(pos_q, pos_k, causal: bool, window: int):
    """(Sq, Sk) boolean mask: True = attend."""
    dq = pos_q[:, None]
    dk = pos_k[None, :]
    m = torch.ones((pos_q.shape[0], pos_k.shape[0]), dtype=torch.bool,
                   device=pos_q.device)
    if causal:
        m &= dk <= dq
    if window > 0:
        m &= dk > dq - window
    return m


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Oracle attention.  q: (B,Sq,H,hd); k,v: (B,Sk,KV,hd) -> (B,Sq,H,hd)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd) * (hd ** -0.5)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    pos_q = q_offset + torch.arange(Sq, device=q.device)
    pos_k = torch.arange(Sk, device=q.device)
    s = torch.where(_mask(pos_q, pos_k, causal, window), s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      q_chunk=1024, kv_chunk=1024):
    """Online-softmax attention, O(S) memory.

    A CUDA tensor goes to the flash-attention kernel at any length (a
    ``meta`` tensor to its stand-in); the kernel has no query offset, so
    ``q_offset != 0`` raises there.
    Otherwise the reference's algorithm: naive below one query chunk or
    for ragged lengths, else a loop over query chunks, each scanning only
    the KV chunks that are not fully masked.

    DTensors run on each device's own heads (``local_map``): q's heads
    split on the model axis where H divides it, k's and v's where KV does
    (or, with one KV head, k and v whole); else every head runs on every
    device of the model axis.
    """
    if isinstance(q, DTensor):
        tp = model_axis_size(q)
        H, KV = q.shape[2], k.shape[2]
        h_dim = 2 if H % tp == 0 and (KV % tp == 0 or KV == 1) else None
        kv_dim = 2 if h_dim is not None and KV % tp == 0 else None

        def local(q, k, v):
            return (chunked_attention(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset, q_chunk=q_chunk,
                                      kv_chunk=kv_chunk),)

        return heads_local(local, (q, k, v),
                           ((h_dim, True), (kv_dim, True), (kv_dim, True)),
                           ((h_dim, True),))[0]
    if q.is_cuda or q.is_meta:
        # on meta tensors (a dry run) the kernel's stand-in
        if q.is_cuda:
            require_kernels("chunked_attention")
        if q_offset:
            raise ValueError(f"chunked_attention: the flash-attention "
                             f"kernel takes no query offset, got "
                             f"q_offset={q_offset}")
        from repro_torch.kernels.flash_attention.ops import (
            flash_attention, flash_attention_stand_in)
        attend = flash_attention if q.is_cuda else flash_attention_stand_in
        return attend(q, k, v, causal=causal, window=window)

    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if Sq % q_chunk or Sk % kv_chunk or Sq <= q_chunk:
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)

    qg = q.reshape(B, Sq, KV, G, hd) * (hd ** -0.5)
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    kc = k.reshape(B, nk, kv_chunk, KV, hd)
    vc = v.reshape(B, nk, kv_chunk, KV, hd)
    blocks = []
    for i in range(nq):
        qi = qg[:, i * q_chunk:(i + 1) * q_chunk].float()
        pos_q = q_offset + i * q_chunk + torch.arange(q_chunk,
                                                      device=q.device)
        m_run = torch.full((B, KV, G, q_chunk), _NEG, device=q.device)
        l_run = torch.zeros((B, KV, G, q_chunk), device=q.device)
        acc = torch.zeros((B, KV, G, q_chunk, hd), device=q.device)
        # causal: kv chunks beyond the diagonal are fully masked -> skip;
        # sliding window additionally bounds how far back we look.
        lo, hi = 0, nk
        if causal:
            hi = min(i + 1, nk)
            if window > 0:
                lo = max(0, (i * q_chunk + q_chunk - window) // kv_chunk)
        for j in range(lo, hi):
            kj, vj = kc[:, j], vc[:, j]
            s = torch.einsum("bqkgd,bckd->bkgqc", qi, kj.float())
            pos_k = j * kv_chunk + torch.arange(kv_chunk, device=q.device)
            s = torch.where(_mask(pos_q, pos_k, causal, window), s, _NEG)
            m_new = torch.maximum(m_run, s.max(dim=-1).values)
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(vj.dtype).float(),
                              vj.float())
            acc = acc * corr[..., None] + pv
            m_run = m_new
        o = acc / torch.clamp(l_run, min=1e-30)[..., None]
        blocks.append(o.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, hd))
    return torch.cat(blocks, dim=1).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0):
    """Single-position attention against a padded KV cache.

    q: (B,1,H,hd); caches: (B,Smax,KV,hd); cache_len: () int tensor, the
    new token's position (keys at positions <= cache_len attend).  No
    kernel: plain PyTorch on every device, as in the reference.  DTensors
    run on each device's own heads (``heads_local``).
    """
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    if isinstance(q, DTensor):
        # each device's own heads where the kv heads divide the model
        # axis, else all of them (the caches gathered whole there)
        tp = model_axis_size(q)
        d = 2 if H % tp == 0 and KV % tp == 0 else None
        return heads_local(
            lambda q, k, v: (decode_attention(q, k, v, cache_len,
                                              window=window),),
            (q, k_cache, v_cache), ((d, True),) * 3, ((d, True),))[0]
    qg = q.reshape(B, KV, G, hd) * (hd ** -0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    pos_k = torch.arange(Smax, device=q.device)
    valid = pos_k <= cache_len
    if window > 0:
        valid &= pos_k > cache_len - window
    s = torch.where(valid, s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def mlp_init(cfg, gen: torch.Generator, d: int, d_ff: int):
    dt = getattr(torch, cfg.dtype)
    if cfg.act == "swiglu":
        return {"wg": dense_init(gen, d, d_ff, dt),
                "wu": dense_init(gen, d, d_ff, dt),
                "wd": dense_init(gen, d_ff, d, dt)}
    return {"w1": dense_init(gen, d, d_ff, dt),
            "w2": dense_init(gen, d_ff, d, dt)}


def mlp_apply(cfg, p, x):
    if cfg.act == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
        return h @ p["wd"]
    h = x @ p["w1"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h, approximate="tanh") if cfg.act == "gelu" \
        else torch.square(F.relu(h))
    return h @ p["w2"]
