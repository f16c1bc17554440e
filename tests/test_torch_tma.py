"""The TMA tensor maps of the bf16 flash kernels B1, B2 and the split pair
B3a + B3b (``ops.flash_attention.tma_geometry`` and ``backward_tma_maps``,
the maps ``csrc/hopper.cuh`` builds), checked without a card: dims, byte
strides and boxes of contiguous operands and of strided views of one
``[B, L, 3, H, D]`` qkv tensor, the f32 dQ workspace, and the raise on what
TMA cannot read."""

import pytest
import torch

from distkeras_torch.ops import flash_attention as fa


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_contiguous_operand(d, dtype):
    t = torch.empty((2, 100, 3, d), dtype=dtype)
    size = t.element_size()
    g = fa.tma_geometry(t, fa.FWD_BOX_ROWS)
    assert g.dims == (d, 3, 100, 2)
    assert g.strides == (d * size, 3 * d * size, 100 * 3 * d * size)
    cols = min(d, 128 // size)  # a box row is at most 128 bytes (the swizzle's span)
    assert g.box == (cols, 1, fa.FWD_BOX_ROWS, 1)
    assert g.boxes * cols == d


@pytest.mark.parametrize("part", [0, 1, 2])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_packed_qkv_view(d, part):
    """q, k or v as the model hands them over: a strided view of one qkv
    tensor; at D = 128 a bf16 row is two boxes of 64 columns."""
    qkv = torch.empty((2, 257, 3, 4, d), dtype=torch.bfloat16)
    t = qkv[:, :, part]
    g = fa.tma_geometry(t, fa.BWD_Q_ROWS)
    assert g.dims == (d, 4, 257, 2)
    assert g.strides == (2 * d, 2 * 3 * 4 * d, 2 * 257 * 3 * 4 * d)
    assert g.box == (min(d, 64), 1, fa.BWD_Q_ROWS, 1)
    assert g.boxes == (2 if d == 128 else 1)
    assert fa.tma_geometry(t, fa.BWD_KEY_ROWS).box == (min(d, 64), 1, fa.BWD_KEY_ROWS, 1)


def test_dq_workspace():
    """B2's f32 [B, Lq, H, D] dQ workspace: boxes of 32 columns (128 bytes)
    by 64 q rows, the tile one reduce-add adds."""
    g = fa.tma_geometry(torch.zeros((8, 2048, 4, 128), dtype=torch.float32), fa.BWD_Q_ROWS)
    assert g.dims == (128, 4, 2048, 8)
    assert g.strides == (512, 4 * 512, 2048 * 4 * 512)
    assert g.box == (32, 1, 64, 1) and g.boxes == 4


def _unreadable(kind):
    if kind == "head stride":  # heads 36 elements (72 bytes) apart
        return torch.empty((2, 10, 3, 36), dtype=torch.bfloat16)[..., :32]
    if kind == "row stride":  # rows 100 elements (200 bytes) apart
        return torch.empty((2, 10, 100), dtype=torch.bfloat16)[:, :, :96].unflatten(-1, (3, 32))
    return torch.empty((2, 10, 32, 3), dtype=torch.bfloat16).transpose(-1, -2)


@pytest.mark.parametrize("kind", ["head stride", "row stride", "head dim"])
def test_unreadable_layouts_raise(kind):
    with pytest.raises(ValueError, match="TMA needs"):
        fa.tma_geometry(_unreadable(kind), fa.FWD_BOX_ROWS)


def test_wrapper_alignment_rule_covers_tma():
    """What the wrappers pass through uncopied (``_rows_aligned``) is
    readable by TMA, and what TMA cannot read the wrappers copy first."""
    views = [torch.empty((2, 100, 3, 64), dtype=torch.bfloat16),
             torch.empty((2, 257, 3, 4, 128), dtype=torch.bfloat16)[:, :, 1],
             torch.empty((2, 257, 3, 4, 32), dtype=torch.float32)[:, :, 2]]
    for t in views:
        assert fa._rows_aligned(t)
        fa.tma_geometry(t, fa.FWD_BOX_ROWS)
    for kind in ("head stride", "row stride", "head dim"):
        t = _unreadable(kind)
        assert not fa._rows_aligned(t)
        fa.tma_geometry(t.clone(memory_format=torch.contiguous_format), fa.FWD_BOX_ROWS)


# box rows of each backward kernel's maps: (q and dO rows, k and v rows)
BACKWARD_BOXES = {"fused": (64, 128), "dq": (128, 64), "dkv": (64, 128)}


def _check_backward_maps(maps, split, dims, strides, d):
    kernels = ("dq", "dkv") if split else ("fused",)
    assert sorted(maps) == sorted(f"{n}.{op}" for n in kernels for op in ("q", "k", "v", "dO"))
    for key, g in maps.items():
        kernel, op = key.split(".")
        q_rows, key_rows = BACKWARD_BOXES[kernel]
        assert g.dims == dims[op] and g.strides == strides[op], key
        assert g.box == (min(d, 64), 1, q_rows if op in ("q", "dO") else key_rows, 1), key
        assert g.boxes == (2 if d == 128 else 1), key


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_backward_maps_contiguous(d, split):
    """Lq != Lk: q and dO maps span Lq rows, k and v Lk; B3a's boxes are
    128 q rows and 64-key tiles, B2's and B3b's 64 q rows and 128 keys."""
    q, do = (torch.empty((2, 100, 3, d), dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.empty((2, 257, 3, d), dtype=torch.bfloat16) for _ in range(2))
    maps = fa.backward_tma_maps(q, k, v, do, split)
    row = 3 * d * 2
    dims = {"q": (d, 3, 100, 2), "dO": (d, 3, 100, 2), "k": (d, 3, 257, 2), "v": (d, 3, 257, 2)}
    strides = {"q": (2 * d, row, 100 * row), "dO": (2 * d, row, 100 * row),
               "k": (2 * d, row, 257 * row), "v": (2 * d, row, 257 * row)}
    _check_backward_maps(maps, split, dims, strides, d)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_backward_maps_packed_qkv(d, split):
    """q, k and v as the model hands them over (views of one qkv tensor,
    rows 3 H D apart), dO contiguous."""
    qkv = torch.empty((2, 130, 3, 4, d), dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.empty((2, 130, 4, d), dtype=torch.bfloat16)
    maps = fa.backward_tma_maps(q, k, v, do, split)
    packed = (2 * d, 2 * 3 * 4 * d, 2 * 130 * 3 * 4 * d)
    dims = dict.fromkeys(("q", "k", "v", "dO"), (d, 4, 130, 2))
    strides = {"q": packed, "k": packed, "v": packed,
               "dO": (2 * d, 2 * 4 * d, 2 * 130 * 4 * d)}
    _check_backward_maps(maps, split, dims, strides, d)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("kind", ["head stride", "row stride", "head dim"])
def test_backward_maps_raise_on_unreadable(kind, split):
    """An operand TMA cannot read raises, whichever operand it is (the
    wrappers copy such tensors first: test_wrapper_alignment_rule_covers_tma)."""
    bad = _unreadable(kind)
    good = torch.empty(bad.shape, dtype=torch.bfloat16)
    for i in range(4):
        ops = [good] * 4
        ops[i] = bad
        with pytest.raises(ValueError, match="TMA needs"):
            fa.backward_tma_maps(*ops, split)
