"""Per-layer paged attention over the serving engine's KV page pools.

Counterpart of ``deeplearning4j_tpu/ops/paged_attention_pallas.py``,
same signature and layout:

- ``q`` ``[N, H, Q, hd]``: query ``i`` of sequence ``n`` sits at absolute
  position ``qbase[n] + i``;
- ``kv`` ``{"k", "v"}``: pools ``[L, n_pages, H, ps, hd]``; flat position
  ``p * ps + o`` of sequence ``n`` lives at ``pool[layer, tables[n, p], :, o]``
  and a key is admitted iff its flat position is ``<= qbase[n] + i``;
- ``tables`` ``[N, P]`` int32, ``qbase`` ``[N]`` int32;
- output ``[N, H, Q, hd]`` in ``q.dtype``.

fp8 KV trees carry ``"k_scale"``/``"v_scale"`` planes ``[L, n_pages, H]``
beside ``float8_e4m3fn`` pools: the plain version dequantizes the
gathered pages in the compute dtype (as the JAX package's XLA reference
does), the kernel in f32 as it stages each page (as the Pallas kernel
does). At f32 the two agree exactly on the dequantized values.

Dispatch is by the device of the tensors and nothing else: CPU tensors
take :func:`paged_attention_reference`, a plain PyTorch copy of the JAX
package's einsum reference; CUDA tensors take the hand-written Hopper
kernel ``csrc/paged_attention.cu`` (:func:`paged_attention_kernel`),
which either launches or raises. There is no fallback from one to the
other, and no mode switch. The kernel takes any query width: it tiles
the queries 32 rows to a block.
"""

from __future__ import annotations

import ctypes
import math

import torch

from deeplearning4j_tpu_torch.ops import native

#: kernel launches since the last reset; incremented only where
#: :func:`paged_attention_kernel` launches the CUDA kernel
launches = 0
#: the part of ``launches`` with more than one query row (verify passes
#: and suffix prefills; decode steps have one)
multi_row_launches = 0

#: shared memory aimed at per block for one tile of staged K/V pages (f32)
_TILE_BYTES = 32 * 1024
_MAX_SMEM = 227 * 1024
#: query rows the kernel's grid can tile (65535 tiles of 32 rows)
_MAX_Q = 65535 * 32


def _gather(pool, layer: int, tables):
    """``pool[layer][tables]``; an fp8 pool is gathered as bytes."""
    if pool.dtype == torch.float8_e4m3fn:
        return pool.view(torch.uint8)[layer][tables].view(pool.dtype)
    return pool[layer][tables]


def paged_attention_reference(q, kv, layer: int, tables, qbase):
    """Plain PyTorch version: page gather, the page-major contraction,
    the ``finfo(dtype).min`` mask on flat position ``<= qbase[n] + i``,
    softmax; fp8 pages are dequantized in the query's dtype first. Op
    for op ``_xla_paged_attention`` (paged_attention_pallas.py:85-111)."""
    N, H, Q, hd = q.shape
    tables = tables.long()
    ck = _gather(kv["k"], layer, tables)         # [N, P, H, ps, hd]
    cv = _gather(kv["v"], layer, tables)
    if "k_scale" in kv:
        cd = q.dtype
        ck = ck.to(cd) * kv["k_scale"][layer][tables][..., None, None].to(cd)
        cv = cv.to(cd) * kv["v_scale"][layer][tables][..., None, None].to(cd)
    P, ps = ck.shape[1], ck.shape[3]
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=q.dtype,
                                          device=q.device))
    qpos = (qbase.long()[:, None]
            + torch.arange(Q, device=q.device)[None, :])
    # page-major contraction: (p, o) together are the flat key axis
    logits = torch.einsum("nhqd,nphod->nhqpo", q, ck) \
        .reshape(N, H, Q, P * ps) * scale
    neg = torch.finfo(logits.dtype).min
    valid = (torch.arange(P * ps, device=q.device)[None, None, None, :]
             <= qpos[:, None, :, None])
    logits = logits.masked_fill(~valid, neg)
    w = torch.softmax(logits, dim=-1).reshape(N, H, Q, P, ps)
    return torch.einsum("nhqpo,nphod->nhqd", w, cv)


def _lib():
    lib = native.load("paged_attention")
    fn = lib.dl4j_paged_attention
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i,
                       i, i, i, i, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_args(q, k, v, layer, tables, qbase, k_scale=None,
                       v_scale=None) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_attention kernel takes float32 or bfloat16 "
                        f"queries, got {q.dtype}")
    fp8 = k_scale is not None or v_scale is not None
    if fp8:
        if k.dtype != torch.float8_e4m3fn or v.dtype != torch.float8_e4m3fn:
            raise TypeError(f"fp8 K/V pools must be float8_e4m3fn, got "
                            f"{k.dtype}, {v.dtype}")
        if k_scale is None or v_scale is None:
            raise ValueError("an fp8 tree needs both k_scale and v_scale")
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or tuple(t.shape) != tuple(k.shape[:3]):
                raise ValueError(f"{name} must be float32 {tuple(k.shape[:3])}"
                                 f", got {t.dtype} {tuple(t.shape)}")
            if not t.is_contiguous() or t.device != q.device:
                raise ValueError(f"{name} must be contiguous on {q.device}")
    elif k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K/V pools ({k.dtype}, {v.dtype}) must match the "
                        f"query dtype {q.dtype}")
    if tables.dtype != torch.int32 or qbase.dtype != torch.int32:
        raise TypeError("tables and qbase must be int32")
    devs = {t.device for t in (q, k, v, tables, qbase)}
    if len(devs) != 1:
        raise ValueError(f"all tensors must be on one device, got {devs}")
    if q.dim() != 4 or k.dim() != 5 or k.shape != v.shape:
        raise ValueError(f"need q [N,H,Q,hd] and pools [L,n_pages,H,ps,hd], "
                         f"got {tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    N, H, Q, hd = q.shape
    L, n_pages, Hk, ps, hdk = k.shape
    if (Hk, hdk) != (H, hd):
        raise ValueError(f"pool heads/head_dim {(Hk, hdk)} != query "
                         f"{(H, hd)}")
    if hd % 32 or not 32 <= hd <= 256:
        raise ValueError(f"head_dim must be a multiple of 32 up to 256, "
                         f"got {hd}")
    if not 1 <= Q <= _MAX_Q:
        raise ValueError(f"the kernel takes 1..{_MAX_Q} query rows, got {Q}")
    if tables.dim() != 2 or tables.shape[0] != N or tuple(qbase.shape) != (N,):
        raise ValueError(f"need tables [N,P] and qbase [N] with N={N}, got "
                         f"{tuple(tables.shape)} / {tuple(qbase.shape)}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the pool's {L} layers")
    if 2 * ps * hd * 4 > _MAX_SMEM:
        raise ValueError(f"one page [{ps}, {hd}] of K and V in f32 exceeds "
                         f"a block's shared memory")
    for name, t in (("q", q), ("k", k), ("v", v), ("tables", tables),
                    ("qbase", qbase)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("K/V pools must be 16-byte aligned")


def paged_attention_kernel(q, kv, layer: int, tables, qbase):
    """Launch ``csrc/paged_attention.cu`` on CUDA tensors, on PyTorch's
    current stream. Raises on any argument the kernel does not take, on
    a failed build and on a refused launch; never computes the result
    another way."""
    global launches, multi_row_launches
    k, v = kv["k"], kv["v"]
    ksc, vsc = kv.get("k_scale"), kv.get("v_scale")
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {q.device}")
    _check_kernel_args(q, k, v, layer, tables, qbase, ksc, vsc)
    fp8 = ksc is not None
    N, H, Q, hd = q.shape
    n_pages, ps = k.shape[1], k.shape[3]
    P = tables.shape[1]
    tile_pages = max(1, min(P, _TILE_BYTES // (2 * ps * hd * 4)))
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dl4j_paged_attention(
            int(q.dtype == torch.bfloat16), int(fp8), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), ksc.data_ptr() if fp8 else None,
            vsc.data_ptr() if fp8 else None, tables.data_ptr(),
            qbase.data_ptr(),
            out.data_ptr(), N, H, Q, hd, ps, P, n_pages, int(layer),
            tile_pages, 1.0 / math.sqrt(hd), stream)
    if err != 0:
        msg = lib.dl4j_cuda_error_string(err).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: {msg} "
                           f"(cudaError {err})")
    launches += 1
    multi_row_launches += int(Q > 1)
    return out


def paged_attention(q, kv, layer: int, tables, qbase):
    """Per-layer paged attention: the reference on CPU tensors, the
    CUDA kernel on CUDA tensors (see the module docstring)."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, kv, layer, tables, qbase)
    if q.device.type == "cuda":
        return paged_attention_kernel(q, kv, layer, tables, qbase)
    raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")
