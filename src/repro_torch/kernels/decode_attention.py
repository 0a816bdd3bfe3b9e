"""Launch wrapper of the hand-written CUDA decode attention
(``csrc/decode_attention.cu``), the Hopper replacement of the TPU kernel
``repro/kernels/decode_attention.py::decode_attention_pallas``.

Contract (that of ``repro_torch.kernels.ref.decode_attention_ref``): q
(B, 1, H, D) float32 or bfloat16; one layer's k and v caches (B, S, HKV,
D), both float32, bfloat16 or int8, int8 with f32 scales (B, S, HKV);
slot_pos (S,) int32 (-1 empty); ``pos`` the current position. Slot s is
visible when ``0 <= slot_pos[s] <= pos`` and, with a window,
``slot_pos[s] > pos - window`` or ``slot_pos[s] < n_sink``. H/HKV <= 16,
D a multiple of 32 up to 256. Returns (B, 1, H, D) in q's dtype; a row
with no visible slot is 0. With ``return_lse`` also the (B, H) f32
log-sum-exp of each row's scaled scores, -inf where no slot is visible
(the plain version's ``return_lse``), for merging attention over a cache
cut into slot ranges; without it the kernel is passed a null pointer and
writes none.

The kernel cuts S into ``n_split`` splits, one block each per (b,
kv-head) (``split`` picks the count); with more than one, the same C entry
point launches a second kernel that merges them. The wrapper checks its
arguments, allocates the output and the splits' scratch with
``torch.empty``, launches on the current stream without synchronizing,
raises if a launch was refused, and counts one launch per call in
``launches["decode_attention"]``. It takes CUDA tensors only: ``ops``
sends CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: kernel launches in this process; a run sets it to 0 (``reset_launches``)
#: and reads it back to show which path went through the kernel
launches = {"decode_attention": 0}

MAX_G = 16       # query heads per KV head (MAX_G in the source)
MAX_D = 256      # head dim, a multiple of 32
MAX_TILE = 128   # cache slots a block stages at once (MAX_TILE in the source)
TILE_BYTES = 64 * 1024   # K and V bytes of one staged tile, at most
MIN_SLOTS = 64   # slots a split, at least
MAX_SPLITS = 128  # splits a (b, kv-head), at most (MAX_SPLITS in the source)
Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def reset_launches() -> None:
    launches["decode_attention"] = 0


def check_args(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               slot_pos: torch.Tensor, *, window: int | None = None,
               n_sink: int = 0, k_scale: torch.Tensor | None = None,
               v_scale: torch.Tensor | None = None) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    if q.dtype not in Q_CODE:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_cache.dtype not in KV_CODE or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"k and v caches must share a dtype of float32, "
                         f"bfloat16 or int8, got {k_cache.dtype} and "
                         f"{v_cache.dtype}")
    b, _, h, d = q.shape
    if k_cache.dim() != 4 or tuple(v_cache.shape) != tuple(k_cache.shape) \
            or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if not (1 <= b <= 65535 and s >= 1 and 1 <= hkv <= h and h % hkv == 0
            and h // hkv <= MAX_G):
        raise ValueError(f"need 1 <= B <= 65535, S >= 1 and H a multiple of "
                         f"HKV with H/HKV <= {MAX_G}: B={b} S={s} H={h} "
                         f"HKV={hkv}")
    if d % 32 != 0 or not 32 <= d <= MAX_D:
        raise ValueError(f"head dim must be a multiple of 32 up to {MAX_D}, "
                         f"got {d}")
    if slot_pos.dtype != torch.int32 or tuple(slot_pos.shape) != (s,):
        raise ValueError(f"slot_pos must be ({s},) int32, got "
                         f"{tuple(slot_pos.shape)} {slot_pos.dtype}")
    scales = (k_scale, v_scale)
    if k_cache.dtype == torch.int8:
        if any(x is None or x.dtype != torch.float32
               or tuple(x.shape) != (b, s, hkv) for x in scales):
            raise ValueError(f"int8 caches need k_scale and v_scale "
                             f"({b}, {s}, {hkv}) float32")
    elif any(x is not None and x.numel() for x in scales):
        raise ValueError("scales go with int8 caches only")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if n_sink < 0:
        raise ValueError(f"n_sink must be >= 0, got {n_sink}")
    tensors = [q, k_cache, v_cache, slot_pos]
    if k_cache.dtype == torch.int8:
        tensors += [k_scale, v_scale]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every operand must be contiguous")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("every operand must be on one device")


def split(s: int, d: int, kv_bytes: int) -> tuple[int, int]:
    """(n_split, tile) of a launch: the S slots of each (b, kv-head) are cut
    into ``n_split`` near-equal splits of at least ``MIN_SLOTS`` slots, as
    many as that allows up to ``MAX_SPLITS`` (so ``n_split == 1`` at S <
    128, the serve path's 96-slot caches), each split one block, walked in
    tiles of ``tile`` slots: one tile a split unless ``MAX_SPLITS`` binds or
    a tile would pass ``MAX_TILE`` slots or ``TILE_BYTES`` of K and V, the
    tiles of a split balanced. Smaller splits put more blocks, hence more
    loads, in flight on each SM; below ``MIN_SLOTS`` the merge costs more
    than that saves (PERF.md, PR 17). B * HKV blocks a split: at the serve
    path's shape (39 misses, 4 KV heads) that alone fills the card."""
    max_tile = max(1, min(MAX_TILE, TILE_BYTES // (2 * d * kv_bytes)))
    n_split = max(1, min(s // MIN_SLOTS, MAX_SPLITS))
    longest = -(-s // n_split)
    return n_split, -(-longest // -(-longest // max_tile))


def scratch(q: torch.Tensor, n_split: int, hkv: int
            ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """(part_acc, part_ml) of a launch with ``n_split`` splits, the splits'
    unnormalized accumulators and (running max, sum); None at one split."""
    if n_split == 1:
        return None, None
    b, _, h, d = q.shape
    g = h // hkv
    part_acc = torch.empty((b, hkv, n_split, g, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, hkv, n_split, g, 2), dtype=torch.float32,
                          device=q.device)
    return part_acc, part_ml


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    if lib.decode_attention_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # q k v k_scale v_scale slot_pos out q_dtype kv_dtype B S H HKV D
        # pos window n_sink scale n_split tile part_acc part_ml lse stream
        lib.decode_attention_launch.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                                i, i, i, i, i, i, i,
                                                ctypes.c_float, i, i, p, p,
                                                p, p]
        lib.decode_attention_launch.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [i]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, slot_pos: torch.Tensor,
                          pos: int, *, window: int | None = None,
                          n_sink: int = 0, scale: float | None = None,
                          k_scale: torch.Tensor | None = None,
                          v_scale: torch.Tensor | None = None,
                          return_lse: bool = False):
    """One query token per sequence over the visible slots of its cache:
    the output, or with ``return_lse`` (output, (B, H) f32 log-sum-exp)."""
    check_args(q, k_cache, v_cache, slot_pos, window=window, n_sink=n_sink,
               k_scale=k_scale, v_scale=v_scale)
    dev = q.device
    if dev.type != "cuda":
        raise RuntimeError(f"the CUDA decode attention takes CUDA tensors, "
                           f"got {dev}; ops routes CPU tensors to the plain "
                           "version")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("q, k and v must be 16-byte aligned")
    lib = _lib()
    b, _, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    quant = k_cache.dtype == torch.int8
    n_split, tile = split(s, d, k_cache.element_size())
    part = scratch(q, n_split, hkv)
    out = torch.empty_like(q)
    lse = torch.empty((b, h), dtype=torch.float32, device=dev) \
        if return_lse else None
    with torch.cuda.device(dev):
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, slot_pos.data_ptr(),
            out.data_ptr(), Q_CODE[q.dtype], KV_CODE[k_cache.dtype], b, s, h,
            hkv, d, int(pos), -1 if window is None else window, n_sink, scale,
            n_split, tile, *(None if t is None else t.data_ptr()
                             for t in (*part, lse)),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention launch failed: {msg}")
    build.count_launch(launches, "decode_attention")
    return (out, lse) if return_lse else out
