"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on a card. Every test here is marked ``cuda`` and skips without one.

The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch; ``tests/conftest.py`` imports JAX, so run it
there without the conftest, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from audio_rag_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    return torch.device("cuda")


def _launched(name, fn):
    """Run ``fn`` and check that it launched kernel ``name`` exactly once."""
    n = K.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert K.LAUNCHES[name] == n + 1
    return out


def _flash_kernel(dtype, D):
    """The kernel the entry runs for contiguous, 16-byte aligned q/k/v."""
    if dtype == torch.bfloat16 and D == 64:
        return "wgmma"
    return "mma" if dtype == torch.bfloat16 and D % 16 == 0 else "cuda_cores"


def _check_flash(q, k, v, kv_len, atol, kernel):
    """One launch, through ``kernel``, within ``atol`` of the plain
    version, and the same bits from a second call."""
    before = dict(K.FLASH_VARIANTS)
    got = _launched("flash_attention",
                    lambda: K.flash_attention(q, k, v, kv_len))
    ran = [n for n, c in K.FLASH_VARIANTS.items() if c != before[n]]
    assert ran == [kernel]
    ref = K.flash_attention_plain(q, k, v, kv_len)
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=0)
    again = K.flash_attention(q, k, v, kv_len)
    assert torch.equal(got, again)
    return got


@pytest.mark.parametrize("shape,dtype,kv_len,atol", [
    ((3, 4, 300, 32), torch.float32, None, 1e-5),
    ((2, 3, 77, 80), torch.bfloat16, None, 2.0 ** -6),    # tensor cores
    ((2, 3, 100, 40), torch.bfloat16, None, 2.0 ** -7),   # CUDA cores
    ((1, 2, 333, 128), torch.bfloat16, 300, 2.0 ** -7),   # masked tail keys
    ((2, 20, 1500, 64), torch.bfloat16, None, 2.0 ** -7),
    # the wgmma kernel: T around its 128-key tiles and 192-row items
    *[((2, 3, T, 64), torch.bfloat16, None, 2.0 ** -7)
      for T in (1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 1500)],
    ((2, 3, 300, 64), torch.bfloat16, 257, 2.0 ** -7),  # one key in the
    ((2, 3, 300, 64), torch.bfloat16, 129, 2.0 ** -7),  # last tile
    ((2, 3, 300, 64), torch.bfloat16, 1, 2.0 ** -7),
    ((3, 7, 2000, 64), torch.bfloat16, 1234, 2.0 ** -7),
    ((1, 1, 200, 64), torch.bfloat16, None, 2.0 ** -7),   # B·H = 1
    ((16, 20, 300, 64), torch.bfloat16, None, 2.0 ** -7),  # B·H = 320
])
def test_flash_kernel_on_card(cuda, shape, dtype, kv_len, atol):
    """bf16 output is one rounding of the f32 result; the tensor-core paths
    also round the probabilities to bf16 before P·V. Each shape runs the
    kernel its dtype and D pick, and gives the same bits twice."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    _check_flash(q, k, v, kv_len, atol, _flash_kernel(dtype, shape[3]))


def test_flash_kernel_takes_head_strided_input(cuda):
    """The encoder hands over (B, T, H, D) projections transposed to
    (B, H, T, D) views; the kernels read them through their strides (the
    wgmma kernel through a 4-D TMA map), at D = 32 and at large-v3's
    (1500, 20, 64)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    for B, T, H, D in ((2, 150, 4, 32), (2, 1500, 20, 64)):
        q, k, v = (torch.randn((B, T, H, D), generator=g, device=cuda)
                   .bfloat16().transpose(1, 2) for _ in range(3))
        _check_flash(q, k, v, None, 2.0 ** -7,
                     _flash_kernel(torch.bfloat16, D))


@pytest.mark.parametrize("view", ["zero_batch_stride", "off_16_bytes"])
def test_flash_kernel_takes_mma_where_tma_cannot(cuda, view):
    """bf16 at D = 64 that no TMA map describes runs on flash_mma_kernel
    (a zero stride), or on the CUDA cores (a pointer off 16 bytes, which
    neither tensor-core kernel takes)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    if view == "zero_batch_stride":
        q, k, v = (torch.randn((1, 3, 150, 64), generator=g, device=cuda)
                   .bfloat16().expand(2, 3, 150, 64) for _ in range(3))
        kernel = "mma"
    else:
        q, k, v = (_unaligned(torch.randn((2, 3, 150, 64), generator=g,
                                          device=cuda).bfloat16())
                   for _ in range(3))
        kernel = "cuda_cores"
    _check_flash(q, k, v, None, 2.0 ** -7, kernel)


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 2, 8, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        K.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="one CUDA device or all"):
        K.flash_attention(q.float(), q.float().cpu(), q.float())
    x = torch.zeros((2, 8), device=cuda)
    w8 = torch.zeros((8, 4), device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError, match="contiguous"):
        K.matmul_q8w(x, w8.t().contiguous().t(), torch.zeros(4, device=cuda))
    qc = torch.zeros((1, 2, 9, 8), device=cuda)
    k8 = torch.zeros((1, 2, 8, 10), device=cuda, dtype=torch.int8)
    sc = torch.ones((1, 2, 1, 1), device=cuda)
    with pytest.raises(ValueError, match="≤ 8"):
        K.decode_cross_attention_q8(qc, k8, k8, sc, sc)


@pytest.mark.parametrize("B,din,dout,dtype", [
    (3, 128, 512, torch.float32),
    (5, 200, 72, torch.bfloat16),     # ragged dout: byte loads
    (37, 300, 260, torch.float32),    # din not a multiple of 16
    (20, 1300, 77, torch.bfloat16),   # byte loads, din split
    (1, 200, 72, torch.bfloat16),
    (8, 300, 260, torch.float32),
    (80, 1300, 77, torch.bfloat16),
    (129, 1280, 1280, torch.bfloat16),  # two row blocks
    (129, 300, 260, torch.float32),
    (16, 1280, 1280, torch.bfloat16),   # split-K, fixed up in the launch
    (16, 1280, 5120, torch.bfloat16),
    (16, 5120, 1280, torch.bfloat16),
    (16, 1280, 51968, torch.bfloat16),
    (80, 1280, 1280, torch.bfloat16),   # beam 5 x 16 windows
    (80, 5120, 1280, torch.bfloat16),
    (80, 1280, 51968, torch.bfloat16),
])
def test_matmul_q8w_kernel_on_card(cuda, B, din, dout, dtype):
    """Exact products (bf16 × int8 fits f32); two f32 summation orders over
    din terms differ by at most 2·din·2⁻²⁴·Σ|x·w| per output."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((B, din), generator=g, device=cuda).to(dtype)
    w8 = torch.randint(-127, 128, (din, dout), generator=g, device=cuda,
                       dtype=torch.int8)
    s = torch.rand((dout,), generator=g, device=cuda) * 0.015 + 0.005
    _check_q8w(x, w8, s)


def _check_q8w(x, w8, s):
    got = _launched("matmul_q8w", lambda: K.matmul_q8w(x, w8, s))
    ref = K.matmul_q8w_plain(x, w8, s)
    mag = torch.matmul(x.bfloat16().float().abs(), w8.float().abs()) * s
    assert bool(((got - ref).abs() <= 2 * x.shape[1] * 2.0 ** -24 * mag)
                .all())


def _unaligned(t):
    """A contiguous copy of ``t`` one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("B,din,dout", [(16, 1280, 1280), (80, 256, 512)])
def test_matmul_q8w_takes_unaligned_views(cuda, B, din, dout):
    """x, w and s one element off their 16-byte alignment: the kernel loads
    them itself instead of by cp.async."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x = _unaligned(torch.randn((B, din), generator=g, device=cuda)
                   .bfloat16())
    w8 = _unaligned(torch.randint(-127, 128, (din, dout), generator=g,
                                  device=cuda, dtype=torch.int8))
    s = _unaligned(torch.rand((dout,), generator=g, device=cuda) * 0.01)
    assert w8.data_ptr() % 16 and s.data_ptr() % 16 and x.data_ptr() % 16
    _check_q8w(x, w8, s)


# the cross kernels: every Ta around the 32-key chunks and the 4-byte rows
# (1, 15, 17, 301, 1501 take the threads' copies), M 1, 2, 5, 8 in both q
# dtypes at B·H = 1, and the large-v3 widths at B·H = 640
_CROSS_EDGES = [(1, 1, M, 64, Ta, dtype)
                for Ta in (1, 15, 16, 17, 301, 1500, 1501)
                for M in (1, 2, 5, 8)
                for dtype in (torch.float32, torch.bfloat16)]
_CROSS_WIDE = [(32, 20, M, 64, Ta, torch.bfloat16)
               for M in (1, 5, 8) for Ta in (1500, 1501)]
# near the longest Ta the plan takes at M = 8 and at M = 1
_CROSS_LONG = [(2, 3, 8, 64, 3400, torch.bfloat16),
               (2, 3, 8, 64, 3399, torch.float32),
               (1, 2, 1, 64, 6000, torch.bfloat16)]


def _cross_inputs(g, bits, B, H, M, hd, Ta, dtype, device):
    """q, K/V bytes (every int8 value, or every nibble) and scales: per
    (b, h) for int8, per channel for int4."""
    q = torch.randn((B, H, M, hd), generator=g, device=device).to(dtype)
    rows, lo = (hd, -127) if bits == 8 else (hd // 2, -128)
    k, v = (torch.randint(lo, 128, (B, H, rows, Ta), generator=g,
                          device=device, dtype=torch.int8) for _ in range(2))
    sc = (B, H, 1, 1) if bits == 8 else (B, H, 1, hd)
    ks, vs = (torch.rand(sc, generator=g, device=device)
              * (0.015 if bits == 8 else 0.09)
              + (0.005 if bits == 8 else 0.01) for _ in range(2))
    return q, k, v, ks, vs


def _check_cross(bits, q, k, v, ks, vs):
    """One launch, within the unchanged tolerance of the plain version (f32
    throughout, sums over Ta keys in another order), and the same bits from
    a second call."""
    name = f"decode_cross_attention_q{bits}"
    fn = getattr(K, name)
    got = _launched(name, lambda: fn(q, k, v, ks, vs))
    ref = getattr(K, name + "_plain")(q, k, v, ks, vs)
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-5)
    assert torch.equal(_bits(_launched(name, lambda: fn(q, k, v, ks, vs))),
                       _bits(got))


@pytest.mark.parametrize("B,H,M,hd,Ta,dtype", [
    (3, 4, 1, 32, 300, torch.float32),
    (2, 3, 5, 64, 301, torch.bfloat16),   # Ta not a multiple of 4
    (2, 4, 8, 64, 128, torch.float32),    # the most queries per row
    (16, 20, 1, 64, 1500, torch.bfloat16),
    (16, 20, 5, 64, 1500, torch.bfloat16),  # beam 5 at large-v3 width
    (16, 20, 8, 64, 1500, torch.bfloat16),  # a speculative verify block
    *_CROSS_EDGES, *_CROSS_WIDE, *_CROSS_LONG,
])
def test_cross_q8_kernel_on_card(cuda, B, H, M, hd, Ta, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    _check_cross(8, *_cross_inputs(g, 8, B, H, M, hd, Ta, dtype, cuda))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,Ta", [(1, 1500), (5, 1500), (8, 301)])
def test_cross_kernels_take_unaligned_views(cuda, bits, M, Ta):
    """K and V one byte past a 16-byte boundary: the plan leaves the bulk
    copies for the threads' copies, decided by the layout alone."""
    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v, ks, vs = _cross_inputs(g, bits, 4, 20, M, 64, Ta,
                                    torch.bfloat16, cuda)
    k, v = _unaligned(k), _unaligned(v)
    assert k.data_ptr() % 16 and v.data_ptr() % 16
    assert not K.cross_plan(bits, 64, Ta, M, aligned=False).bulk
    _check_cross(bits, q, k, v, ks, vs)


def test_cross_kernels_refuse_what_the_plan_refuses(cuda):
    """A head dim the m16 tiles do not cut evenly, and M rows of Ta scores
    past shared memory, raise before any launch."""
    g = torch.Generator(device=cuda).manual_seed(13)
    n = K.LAUNCHES["decode_cross_attention_q8"]
    with pytest.raises(ValueError, match="head dim"):
        K.decode_cross_attention_q8(*_cross_inputs(g, 8, 1, 2, 1, 40, 64,
                                                   torch.float32, cuda))
    with pytest.raises(ValueError, match="shared memory"):
        K.decode_cross_attention_q8(*_cross_inputs(g, 8, 1, 1, 8, 64, 8000,
                                                   torch.float32, cuda))
    assert K.LAUNCHES["decode_cross_attention_q8"] == n


def _q4_weight(g, din, dout, group, device):
    """Random packed int4 bytes (every nibble value) and group scales."""
    w4 = torch.randint(-128, 128, (din // 2, dout), generator=g,
                       device=device, dtype=torch.int8)
    s = torch.rand((din // group, dout), generator=g, device=device) \
        * 0.015 + 0.005
    return w4, s


@pytest.mark.parametrize("B,din,dout,group,dtype", [
    (3, 128, 512, 128, torch.float32),
    (5, 200, 72, 40, torch.bfloat16),     # ragged dout: byte loads
    (37, 300, 260, 3, torch.float32),     # odd group: row pairs span groups
    (20, 1300, 77, 100, torch.bfloat16),  # din split
    (1, 200, 72, 40, torch.bfloat16),
    (8, 300, 260, 3, torch.bfloat16),
    (80, 1300, 77, 100, torch.float32),
    (129, 1280, 1280, 80, torch.bfloat16),  # two row blocks
    (129, 300, 260, 3, torch.float32),
    (32, 1280, 51968, 80, torch.bfloat16),  # the int4 logits head
    (80, 1280, 51968, 80, torch.bfloat16),  # ... at beam 5 x 16 windows
    (16, 1280, 1280, 80, torch.bfloat16),
    (16, 1280, 5120, 80, torch.bfloat16),
    (16, 5120, 1280, 128, torch.bfloat16),
    (80, 5120, 1280, 128, torch.bfloat16),
    (16, 512, 128, 64, torch.float32),      # tiny-synth's widths
])
def test_matmul_q4w_kernel_on_card(cuda, B, din, dout, group, dtype):
    """Exact products (bf16 × int4·bf16 scale fits f32); two f32 summation
    orders over din terms differ by at most 2·din·2⁻²⁴·Σ|x·w| per output."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((B, din), generator=g, device=cuda).to(dtype)
    w4, s = _q4_weight(g, din, dout, group, cuda)
    _check_q4w(x, w4, s)


def _check_q4w(x, w4, s):
    got = _launched("matmul_q4w", lambda: K.matmul_q4w(x, w4, s))
    ref = K.matmul_q4w_plain(x, w4, s)
    mag = torch.matmul(x.bfloat16().float().abs(), K.dequant_q4w(w4, s).abs())
    assert bool(((got - ref).abs() <= 2 * x.shape[1] * 2.0 ** -24 * mag)
                .all())


@pytest.mark.parametrize("B,din,dout,group", [(16, 1280, 1280, 80),
                                              (80, 300, 512, 3)])
def test_matmul_q4w_takes_unaligned_views(cuda, B, din, dout, group):
    g = torch.Generator(device=cuda).manual_seed(10)
    x = _unaligned(torch.randn((B, din), generator=g, device=cuda)
                   .bfloat16())
    w4, s = (_unaligned(t) for t in _q4_weight(g, din, dout, group, cuda))
    assert w4.data_ptr() % 16 and s.data_ptr() % 16 and x.data_ptr() % 16
    _check_q4w(x, w4, s)


@pytest.mark.parametrize("name,B,din,dout,group", [
    ("matmul_q8w", 16, 1280, 1280, None),   # 10 din slices
    ("matmul_q8w", 80, 5120, 1280, None),
    ("matmul_q4w", 16, 5120, 1280, 128),    # scaled chunk sums
    ("matmul_q4w", 129, 1300, 1280, 100),   # hi + lo
])
def test_split_k_is_one_launch_and_deterministic(cuda, name, B, din, dout,
                                                 group):
    """A call whose din is split across blocks is still one launch (the
    last block of each tile adds the slices), and two calls give the same
    bits: the slices are added in a fixed order, with no atomics on the
    values."""
    plan = K.wq_plan(B, din, dout, bits=8 if group is None else 4,
                     group=group)
    assert plan.splits > 1
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((B, din), generator=g, device=cuda).bfloat16()
    if group is None:
        w = torch.randint(-127, 128, (din, dout), generator=g, device=cuda,
                          dtype=torch.int8)
        s = torch.rand((dout,), generator=g, device=cuda) * 0.01
    else:
        w, s = _q4_weight(g, din, dout, group, cuda)
    fn = getattr(K, name)
    first = _launched(name, lambda: fn(x, w, s))
    for _ in range(3):
        assert torch.equal(_bits(_launched(name, lambda: fn(x, w, s))),
                           _bits(first))


@pytest.mark.parametrize("B,H,M,hd,Ta,dtype", [
    (3, 4, 1, 32, 300, torch.float32),
    (2, 3, 5, 64, 301, torch.bfloat16),   # Ta not a multiple of 4
    (2, 4, 8, 64, 128, torch.float32),    # the most queries per row
    (32, 20, 1, 64, 1500, torch.bfloat16),
    (16, 20, 5, 64, 1500, torch.bfloat16),  # beam 5 at large-v3 width
    (16, 20, 8, 64, 1500, torch.bfloat16),  # a speculative verify block
    (16, 20, 1, 64, 1500, torch.bfloat16),  # the capacity profile
    *_CROSS_EDGES, *_CROSS_WIDE, *_CROSS_LONG,
])
def test_cross_q4_kernel_on_card(cuda, B, H, M, hd, Ta, dtype):
    g = torch.Generator(device=cuda).manual_seed(5)
    _check_cross(4, *_cross_inputs(g, 4, B, H, M, hd, Ta, dtype, cuda))


def _self_inputs(g, B, H, M, hd, Cp, n_valid, dtype, device):
    q = torch.randn((B, H, M, hd), generator=g, device=device).to(dtype)
    k8, v8 = (torch.randint(-127, 128, (B, H, hd, Cp), generator=g,
                            device=device, dtype=torch.int8)
              for _ in range(2))
    sc = torch.zeros((B, Cp, 128), device=device)
    sc[:, :, :2 * H] = torch.rand((B, Cp, 2 * H), generator=g,
                                  device=device) * 0.02 + 0.001
    sc[:, :, 2 * H] = torch.where(torch.arange(Cp, device=device) < n_valid,
                                  0.0, -1e30)
    return q, k8, v8, sc


# the self kernel: Cp around the 4-byte words, the 16-byte bulk copies and
# the 256 threads (1, 127, 129 take the threads' copies), M 1, 2, 5, 8,
# hd 32, 64, 128 and n_valid 0, 1, Cp in turn, both q dtypes, at B·H = 1;
# the capacity profile's width at B·H = 320; long caches in stages
_SELF_EDGES = [(1, 1, M, (32, 64, 128)[(i + j) % 3], Cp,
                (0, 1, Cp)[(i + 2 * j) % 3],
                (torch.float32, torch.bfloat16)[j % 2])
               for i, Cp in enumerate((1, 127, 128, 129, 256, 448, 512, 2048))
               for j, M in enumerate((1, 2, 5, 8))]
_SELF_WIDE = [(16, 20, M, 64, Cp, n, dtype)
              for M in (1, 8) for Cp, n in ((256, 40), (448, 448), (512, 1))
              for dtype in (torch.float32, torch.bfloat16)]
_SELF_LONG = [(2, 3, 8, 128, 2048, 2000, torch.bfloat16),  # two slots
              (1, 2, 8, 64, 2128, 2128, torch.float32),    # the plan's limit
              (1, 2, 1, 64, 4432, 4000, torch.bfloat16)]


def _check_self(q, k8, v8, sc):
    """One launch, finite, within the unchanged tolerance of the plain
    version (f32 throughout; sums over Cp positions in another order, the V
    scales applied before the normaliser instead of after), and the same
    bits from a second call."""
    name = "decode_self_attention_q8"
    got = _launched(name, lambda: K.decode_self_attention_q8(q, k8, v8, sc))
    ref = K.decode_self_attention_q8_plain(q, k8, v8, sc)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    again = _launched(name, lambda: K.decode_self_attention_q8(q, k8, v8, sc))
    assert torch.equal(_bits(again), _bits(got))


@pytest.mark.parametrize("B,H,M,hd,Cp,n_valid,dtype", [
    (2, 4, 1, 32, 128, 37, torch.float32),
    (3, 5, 2, 64, 130, 100, torch.bfloat16),  # Cp not a multiple of 4
    (1, 4, 1, 32, 128, 0, torch.float32),     # no valid position: finite
    (16, 20, 1, 64, 256, 40, torch.bfloat16),
    (1, 1, 3, 16, 200, 150, torch.float32),   # hd 16: 16 lanes a V row
    (2, 3, 8, 16, 1, 1, torch.bfloat16),
    *_SELF_EDGES, *_SELF_WIDE, *_SELF_LONG,
])
def test_self_q8_kernel_on_card(cuda, B, H, M, hd, Cp, n_valid, dtype):
    g = torch.Generator(device=cuda).manual_seed(6)
    _check_self(*_self_inputs(g, B, H, M, hd, Cp, n_valid, dtype, cuda))


@pytest.mark.parametrize("M,Cp", [(1, 256), (5, 512), (8, 2048)])
def test_self_kernel_takes_unaligned_views(cuda, M, Cp):
    """K and V one byte past a 16-byte boundary: the plan leaves the bulk
    copies for the threads' copies, decided by the layout alone."""
    g = torch.Generator(device=cuda).manual_seed(14)
    q, k8, v8, sc = _self_inputs(g, 4, 20, M, 64, Cp, Cp - 3,
                                 torch.bfloat16, cuda)
    k8, v8 = _unaligned(k8), _unaligned(v8)
    assert k8.data_ptr() % 16 and v8.data_ptr() % 16
    assert not K.self_plan(64, Cp, M, aligned=False).bulk
    _check_self(q, k8, v8, sc)


def test_self_kernel_refuses_what_the_plan_refuses(cuda):
    """More than 8 queries a row, a head dim other than 16, 32, 64 or 128,
    and slots, scores and columns past shared memory raise before any
    launch."""
    g = torch.Generator(device=cuda).manual_seed(15)
    name = "decode_self_attention_q8"
    n = K.LAUNCHES[name]
    with pytest.raises(ValueError, match="≤ 8"):
        K.decode_self_attention_q8(*_self_inputs(g, 1, 2, 9, 64, 256, 9,
                                                 torch.float32, cuda))
    with pytest.raises(ValueError, match="head dim"):
        K.decode_self_attention_q8(*_self_inputs(g, 1, 2, 1, 40, 256, 9,
                                                 torch.float32, cuda))
    with pytest.raises(ValueError, match="shared memory"):
        K.decode_self_attention_q8(*_self_inputs(g, 1, 2, 8, 64, 2144, 9,
                                                 torch.float32, cuda))
    assert K.LAUNCHES[name] == n


def test_new_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((2, 8), device=cuda)
    w4 = torch.zeros((4, 4), device=cuda, dtype=torch.int8)
    s = torch.ones((1, 4), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.matmul_q4w(x, w4.t().contiguous().t(), s)
    q = torch.zeros((1, 2, 9, 8), device=cuda)
    k4 = torch.zeros((1, 2, 4, 10), device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError, match="≤ 8"):
        K.decode_cross_attention_q4(q, k4, k4, torch.ones((1, 2, 1, 8),
                                                          device=cuda),
                                    torch.ones((1, 2, 1, 8), device=cuda))
    k8 = torch.zeros((1, 2, 8, 128), device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError, match="one CUDA device or all"):
        K.decode_self_attention_q8(q[:, :, :1], k8, k8,
                                   torch.zeros((1, 128, 128)))


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.mark.parametrize("shape,dtype,index", [
    ((2, 6, 2, 4, 16), torch.float32, "random"),
    ((3, 10, 3, 7, 5), torch.bfloat16, "random"),     # ragged: byte path
    ((3, 10, 3, 7, 5), torch.bfloat16, "identity"),   # aligned rows + tail
    ((2, 12, 4, 9, 64), torch.float32, "fanout"),     # one source, 12 rows
    ((4, 80, 20, 36, 64), torch.bfloat16, "random"),
    ((1, 40, 1, 7296, 128), torch.bfloat16, "random"),  # long slabs
])
def test_beam_reorder_kernel_on_card(cuda, shape, dtype, index):
    """A permutation copies bits: kernel and plain version agree exactly."""
    g = torch.Generator(device=cuda).manual_seed(7)
    sk, sv = (torch.randn(shape, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    N = shape[1]
    idx = {"random": torch.randint(0, N, (N,), generator=g, device=cuda),
           "identity": torch.arange(N, device=cuda),
           "fanout": torch.full((N,), 3, device=cuda)}[index]
    got = _launched("beam_reorder_kv", lambda: K.beam_reorder_kv(sk, sv, idx))
    for a, b in zip(got, K.beam_reorder_kv_plain(sk, sv, idx)):
        assert torch.equal(_bits(a), _bits(b))


def test_beam_reorder_refuses_what_it_does_not_take(cuda):
    sk = torch.zeros((2, 4, 2, 3, 8), device=cuda)
    idx = torch.arange(4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.beam_reorder_kv(sk.transpose(3, 4), sk.transpose(3, 4), idx)
    with pytest.raises(ValueError, match="int64"):
        K.beam_reorder_kv(sk, sk, idx.int())
    with pytest.raises(ValueError, match="one CUDA device or all"):
        K.beam_reorder_kv(sk, sk, idx.cpu())


def test_onehot_reorder_is_exact_with_tf32_on(cuda):
    """The one-hot matmul reorder of f32 caches stays exact when the global
    switch allows TF32 (it turns TF32 off around itself), and leaves the
    switch as it found it."""
    from audio_rag_tpu_torch.models.whisper import _onehot_reorder

    g = torch.Generator(device=cuda).manual_seed(8)
    sk, sv = (torch.randn((3, 15, 4, 20, 64), generator=g, device=cuda)
              for _ in range(2))
    idx = torch.randint(0, 15, (15,), generator=g, device=cuda)
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")  # TF32 on
    try:
        got = _onehot_reorder((sk, sv), idx)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
    for a, b in zip(got, K.beam_reorder_kv_plain(sk, sv, idx)):
        assert torch.equal(_bits(a), _bits(b))


# -- gradients (fault 14) ------------------------------------------------------

def _encoder_grads(params, dims, mel, w, device):
    """Gradients of Σ(encode(mel)·w) for every encoder leaf on ``device``,
    forward and backward in full f32."""
    from audio_rag_tpu_torch.device import full_f32
    from audio_rag_tpu_torch.models.whisper import encode

    leaves = {}

    def place(tree, prefix):
        out = {}
        for key, val in tree.items():
            name = f"{prefix}/{key}"
            if isinstance(val, dict):
                out[key] = place(val, name)
            else:
                out[key] = leaves[name] = (val.to(device).clone()
                                           .requires_grad_(True))
        return out

    p = {"encoder": place(params["encoder"], "encoder")}
    with full_f32(device):
        (encode(p, dims, mel.to(device), dtype=torch.float32)
         * w.to(device)).sum().backward()
    return {name: t.grad for name, t in leaves.items()}


def test_encode_gradient_on_card_matches_cpu(cuda):
    """Fault 14: the flash kernel's output carried no gradient on CUDA, so
    the encoder attention's q, k and v (and what lies below them) got the
    residual path's gradient only. Every encoder leaf's gradient on the
    card is within 1e-4 of its largest CPU value (f32 on both sides, sums
    in other orders), and the card's encode launched the kernel once a
    layer."""
    from audio_rag_tpu_torch.models.whisper import (WHISPER_PRESETS,
                                                    init_whisper)

    dims = WHISPER_PRESETS["tiny-synth"]
    params = init_whisper(dims, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    mel = torch.randn((2, dims.n_mels, 2 * dims.n_audio_ctx), generator=g)
    w = torch.randn((2, dims.n_audio_ctx, dims.n_audio_state), generator=g)
    n = K.LAUNCHES["flash_attention"]
    card = _encoder_grads(params, dims, mel, w, cuda)
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_attention"] == n + dims.n_audio_layer
    cpu = _encoder_grads(params, dims, mel, w, "cpu")
    for name, ref in cpu.items():
        got = card[name]
        assert got is not None, f"{name}: no gradient on the card"
        tol = 1e-4 * ref.abs().max().item()
        torch.testing.assert_close(got.cpu(), ref, atol=tol, rtol=0,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("shape,dtype,kv_len,layout", [
    ((2, 4, 300, 32), torch.float32, None, "bthd"),
    ((2, 3, 200, 64), torch.bfloat16, None, "bthd"),
    ((2, 3, 200, 64), torch.float32, 150, "bhtd"),
])
def test_flash_gradient_on_card(cuda, shape, dtype, kv_len, layout):
    """``FlashAttentionFn``: one kernel launch forward, dq/dk/dv within
    1e-4 (f32) or two bf16 ulps (bf16: the kernel's output and each
    gradient rounded) of the largest gradient of autograd through the
    plain version, and the same bits from a second call."""
    from audio_rag_tpu_torch.device import full_f32

    B, H, T, D = shape
    g = torch.Generator(device=cuda).manual_seed(2)
    base_shape = (B, T, H, D) if layout == "bthd" else shape
    bases = [torch.randn(base_shape, generator=g, device=cuda).to(dtype)
             .requires_grad_(True) for _ in range(3)]
    q, k, v = (x.transpose(1, 2) if layout == "bthd" else x for x in bases)
    do = torch.randn((B, H, T, D), generator=g, device=cuda).to(dtype)
    with full_f32(cuda):
        got = torch.autograd.grad(
            _launched("flash_attention",
                      lambda: K.flash_attention(q, k, v, kv_len)), bases, do)
        again = torch.autograd.grad(K.flash_attention(q, k, v, kv_len),
                                    bases, do)
        ref = torch.autograd.grad(K.flash_attention_plain(q, k, v, kv_len),
                                  bases, do)
    top = max(1.0, max(r.float().abs().max().item() for r in ref))
    tol = (1e-4 if dtype == torch.float32 else 2.0 ** -6) * top
    for a, b, c in zip(got, ref, again):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=0)
        assert torch.equal(a, c)


def test_kernels_without_a_backward_refuse_grad(cuda):
    """Every wrapper but flash raises when grad mode is on and an input
    requires grad (its kernel's output would carry no gradient), and runs
    under ``torch.no_grad()``."""
    x = torch.randn((4, 256), device=cuda, requires_grad=True)
    w8 = torch.ones((256, 512), dtype=torch.int8, device=cuda)
    w4 = torch.ones((128, 512), dtype=torch.int8, device=cuda)
    s8 = torch.ones((512,), device=cuda)
    s4 = torch.ones((2, 512), device=cuda)
    q = torch.randn((1, 2, 1, 64), device=cuda, requires_grad=True)
    kv8 = torch.ones((1, 2, 64, 16), dtype=torch.int8, device=cuda)
    kv4 = torch.ones((1, 2, 32, 16), dtype=torch.int8, device=cuda)
    s11 = torch.ones((1, 2, 1, 1), device=cuda)
    s1d = torch.ones((1, 2, 1, 64), device=cuda)
    sc = torch.zeros((1, 16, K.SELF_LANES), device=cuda)
    cache = torch.zeros((1, 2, 1, 4, 8), device=cuda, requires_grad=True)
    idx = torch.tensor([1, 0], device=cuda)
    calls = [
        lambda: K.matmul_q8w(x, w8, s8),
        lambda: K.matmul_q4w(x, w4, s4),
        lambda: K.decode_cross_attention_q8(q, kv8, kv8, s11, s11),
        lambda: K.decode_cross_attention_q4(q, kv4, kv4, s1d, s1d),
        lambda: K.decode_self_attention_q8(q, kv8, kv8, sc),
        lambda: K.beam_reorder_kv(cache, cache, idx),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()
