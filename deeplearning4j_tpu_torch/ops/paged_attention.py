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
does), the kernel in f32 as it reads each page (as the Pallas kernel
does; its tensor-core tiles under bf16 queries then round the values to
bf16). At f32 the two agree exactly on the dequantized values.

Dispatch is by the device of the tensors and nothing else: CPU tensors
take :func:`paged_attention_reference`, a plain PyTorch copy of the JAX
package's einsum reference; CUDA tensors take the hand-written Hopper
kernel ``csrc/paged_attention.cu`` (:func:`paged_attention_kernel`),
which either launches or raises. There is no fallback from one to the
other, and no mode switch. The kernel takes any query width, every pool
type and every head width that is a multiple of 32 up to 256: one block
per sequence, head and query tile (1 row at Q=1, else 8), its warps
sharing the visible keys in 32-key chunks, planned by
:func:`launch_plan`.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple

import torch

from deeplearning4j_tpu_torch.ops import native
from deeplearning4j_tpu_torch.ops.registry import register_op

#: kernel launches since the last reset; incremented only where
#: :func:`paged_attention_kernel` launches the CUDA kernel (one per call)
launches = 0
#: the part of ``launches`` with more than one query row (verify passes
#: and suffix prefills; decode steps have one)
multi_row_launches = 0

#: query rows the kernel takes and blocks its grid takes (C ints)
_MAX_Q = _MAX_BLOCKS = 2 ** 31 - 1
#: shared memory of one H100 SM that the kernel's blocks may share (228
#: KB; the card reserves 1 KB of it per block, so one block may take 227
#: KB), and the keys of a warp's chunk (one per lane)
SMEM_PER_SM = 233472
_CHUNK = 32


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


class LaunchPlan(NamedTuple):
    """The kernel's launch plan: query rows per block tile (1 at Q=1,
    else 8), tiles, warps per block, and the block's shared memory in
    bytes."""
    rows: int
    tiles: int
    warps: int
    smem: int


def block_smem(rows: int, hd: int, kv_bytes: int, P: int,
               warps: int) -> int:
    """Shared memory of one block in bytes, as the kernel lays it out
    (``head_bytes``, ``warp_bytes``): the query rows in f32 and the page
    ids, then per warp two stages of K and V rows padded by 16 bytes plus
    the fp8 scales, the probabilities, and for fp8 pools under 8-row tiles
    the chunk dequantized to bf16."""
    stage = 2 * _CHUNK * (hd * kv_bytes + 16) + 2 * _CHUNK * 4
    conv = 2 * _CHUNK * (hd + 8) * 2 if kv_bytes == 1 and rows == 8 else 0
    per_warp = 2 * stage + _CHUNK * rows * 4 + conv
    head = -(-(rows * hd * 4 + P * 4) // 16) * 16
    return head + warps * per_warp


def launch_plan(N: int, H: int, Q: int, P: int, ps: int, hd: int,
                kv_bytes: int, sms: int,
                smem_per_sm: int = SMEM_PER_SM) -> LaunchPlan:
    """The kernel's plan, in plain Python: as many warps, up to 8, as have
    their two-stage rings of 32-key chunks fit beside the block's query
    rows and page-table row in ``smem_per_sm``, or in half of it where the
    grid has more (sequence, head, tile) blocks than the card has SMs (two
    blocks per SM: one wave); at least one. Raises where one warp does not
    fit a block's shared memory (a page table too wide)."""
    rows = 1 if Q == 1 else 8
    tiles = -(-Q // rows)
    blocks = N * H * tiles
    if blocks > _MAX_BLOCKS:
        raise ValueError(f"{blocks} blocks (N * H * query tiles) exceed the "
                         f"kernel's grid of {_MAX_BLOCKS}")
    head = block_smem(rows, hd, kv_bytes, P, 0)
    per_warp = block_smem(rows, hd, kv_bytes, P, 1) - head
    per_block = smem_per_sm // (1 if blocks <= sms else 2) - 1024
    warps = max(1, min(8, (per_block - head) // per_warp))
    smem = head + warps * per_warp
    if smem > smem_per_sm - 1024:
        raise ValueError(f"one warp's ring at head_dim {hd} beside a page "
                         f"table of {P} pages needs {smem} bytes of shared "
                         f"memory, more than a block's {smem_per_sm - 1024}")
    return LaunchPlan(rows, tiles, warps, smem)


def _lib():
    lib = native.load("paged_attention")
    fn = lib.dl4j_paged_attention
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, i, ctypes.c_float]
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
    for name, t in (("q", q), ("k", k), ("v", v), ("tables", tables),
                    ("qbase", qbase)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("K/V pools must be 16-byte aligned")


#: validated calls: a key of every property the checks read (shapes,
#: dtypes, devices, layouts, alignment, layer) -> the device index and the
#: packed int arguments, so a repeated call skips the checks' branches and
#: the planning
_plans: dict = {}
_MAX_PLANS = 4096
_raw_stream = None
#: per thread, the packed pointer arguments
_local = threading.local()


def _current_stream(index: int) -> int:
    global _raw_stream
    if _raw_stream is None:
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) \
            or (lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _raw_stream(index)


def _call_key(q, k, v, layer, tables, qbase, ksc, vsc):
    # get_device() (an int, -1 on the CPU) costs less than .device
    def props(t):
        return (None if t is None else
                (t.shape, t.dtype, t.get_device(), t.is_contiguous()))
    return (props(q), props(k), k.data_ptr() % 16, props(v),
            v.data_ptr() % 16, props(tables), props(qbase), props(ksc),
            props(vsc), layer)


def pack_ints(q, k, tables, plan: LaunchPlan, index: int, fp8: bool):
    """The C entry's int arguments for a call planned by ``plan``."""
    N, H, Q, hd = q.shape
    return (ctypes.c_int * 12)(
        int(q.dtype == torch.bfloat16), int(fp8), N, H, Q, hd, k.shape[3],
        tables.shape[1], k.shape[1], plan.rows, plan.warps, index)


def _plan_call(q, k, v, layer, tables, qbase, ksc, vsc):
    """Check a call the first time its key is seen and plan it: (device
    index, packed int arguments)."""
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {q.device}")
    _check_kernel_args(q, k, v, layer, tables, qbase, ksc, vsc)
    N, H, Q, hd = q.shape
    index = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    plan = launch_plan(N, H, Q, tables.shape[1], k.shape[3], hd,
                       k.element_size(), sms)
    return index, pack_ints(q, k, tables, plan, index, ksc is not None)


def launch(q, kv, layer: int, tables, qbase, index: int, ints):
    """One launch of the kernel with packed int arguments (see
    :func:`pack_ints`) on PyTorch's current stream; the output, or a
    RuntimeError. No checks and no count: :func:`paged_attention_kernel`
    checks, plans and counts."""
    k, v = kv["k"], kv["v"]
    ksc, vsc = kv.get("k_scale"), kv.get("v_scale")
    fp8 = ksc is not None
    out = torch.empty_like(q)
    lib = _lib()
    ptrs = getattr(_local, "ptrs", None)
    if ptrs is None:
        ptrs = _local.ptrs = (ctypes.c_void_p * 9)()
    ptrs[:] = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
               ksc.data_ptr() if fp8 else 0, vsc.data_ptr() if fp8 else 0,
               tables.data_ptr(), qbase.data_ptr(), out.data_ptr(),
               _current_stream(index))
    err = lib.dl4j_paged_attention(ptrs, ints, int(layer),
                                   1.0 / math.sqrt(q.shape[-1]))
    if err != 0:
        msg = lib.dl4j_cuda_error_string(err).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: {msg} "
                           f"(cudaError {err})")
    return out


def paged_attention_kernel(q, kv, layer: int, tables, qbase):
    """Launch ``csrc/paged_attention.cu`` on CUDA tensors, on PyTorch's
    current stream, as :func:`launch_plan` plans it. Raises on any
    argument the kernel does not take, on a failed build and on a refused
    launch; never computes the result another way. The checks run once per
    distinct call key (:data:`_plans`)."""
    global launches, multi_row_launches
    k, v = kv["k"], kv["v"]
    ksc, vsc = kv.get("k_scale"), kv.get("v_scale")
    key = _call_key(q, k, v, layer, tables, qbase, ksc, vsc)
    plan = _plans.get(key)
    if plan is None:
        plan = _plan_call(q, k, v, layer, tables, qbase, ksc, vsc)
        if len(_plans) >= _MAX_PLANS:
            _plans.clear()
        _plans[key] = plan
    out = launch(q, kv, layer, tables, qbase, *plan)
    launches += 1
    multi_row_launches += int(q.shape[2] > 1)
    return out


def paged_attention(q, kv, layer: int, tables, qbase):
    """Per-layer paged attention: the reference on CPU tensors, the
    CUDA kernel on CUDA tensors (see the module docstring)."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, kv, layer, tables, qbase)
    if q.device.type == "cuda":
        return paged_attention_kernel(q, kv, layer, tables, qbase)
    raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")


@register_op("paged_attention")
def _op(q, kv, layer, tables, qbase, mode=None):
    """:func:`paged_attention` by JAX's name. ``mode`` is JAX's choice of
    path: a value other than None, "pallas", "interpret" or "xla" raises
    ``ValueError`` as in JAX, and every valid value takes the same
    dispatch (B6 on CUDA tensors, the plain version on CPU tensors)."""
    if mode not in (None, "xla", "pallas", "interpret"):
        raise ValueError(
            f"unknown paged-attention mode {mode!r} (expected 'pallas',"
            " 'interpret' or 'xla')")
    return paged_attention(q, kv, int(layer), tables, qbase)
