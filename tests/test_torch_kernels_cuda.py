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


@pytest.mark.parametrize("shape,dtype,kv_len,atol", [
    ((3, 4, 300, 32), torch.float32, None, 1e-5),
    ((2, 3, 77, 80), torch.bfloat16, None, 2.0 ** -6),    # tensor cores
    ((2, 3, 100, 40), torch.bfloat16, None, 2.0 ** -7),   # CUDA cores
    ((1, 2, 333, 128), torch.bfloat16, 300, 2.0 ** -7),   # masked tail keys
    ((2, 20, 1500, 64), torch.bfloat16, None, 2.0 ** -7),
])
def test_flash_kernel_on_card(cuda, shape, dtype, kv_len, atol):
    """bf16 output is one rounding of the f32 result; the tensor-core path
    also rounds the probabilities to bf16 before P·V."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    got = _launched("flash_attention",
                    lambda: K.flash_attention(q, k, v, kv_len))
    ref = K.flash_attention_plain(q, k, v, kv_len)
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=0)


def test_flash_kernel_takes_head_strided_input(cuda):
    """The encoder hands over (B, T, H, D) projections transposed to
    (B, H, T, D) views; the kernel reads them through their strides."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn((2, 150, 4, 32), generator=g, device=cuda)
               .bfloat16().transpose(1, 2) for _ in range(3))
    got = _launched("flash_attention", lambda: K.flash_attention(q, k, v))
    ref = K.flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), ref.float(), atol=2.0 ** -7,
                               rtol=0)


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
    (5, 200, 72, torch.bfloat16),
    (37, 300, 260, torch.float32),    # two 16-row chunks of x
    (20, 1300, 77, torch.bfloat16),   # byte loads, din split
    (16, 1280, 5120, torch.bfloat16),
    (16, 5120, 1280, torch.bfloat16),
    (16, 1280, 51968, torch.bfloat16),
])
def test_matmul_q8w_kernel_on_card(cuda, B, din, dout, dtype):
    """Exact products (bf16 × int8 fits f32); two f32 summation orders over
    din terms differ by at most 2·din·2⁻²⁴·Σ|x·w| per output."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((B, din), generator=g, device=cuda).to(dtype)
    w8 = torch.randint(-127, 128, (din, dout), generator=g, device=cuda,
                       dtype=torch.int8)
    s = torch.rand((dout,), generator=g, device=cuda) * 0.015 + 0.005
    got = _launched("matmul_q8w", lambda: K.matmul_q8w(x, w8, s))
    ref = K.matmul_q8w_plain(x, w8, s)
    mag = torch.matmul(x.bfloat16().float().abs(), w8.float().abs()) * s
    assert bool(((got - ref).abs() <= 2 * din * 2.0 ** -24 * mag).all())


@pytest.mark.parametrize("B,H,M,hd,Ta,dtype", [
    (3, 4, 1, 32, 300, torch.float32),
    (2, 3, 5, 64, 301, torch.bfloat16),   # Ta not a multiple of 4
    (2, 4, 8, 64, 128, torch.float32),    # the most queries per row
    (16, 20, 1, 64, 1500, torch.bfloat16),
])
def test_cross_q8_kernel_on_card(cuda, B, H, M, hd, Ta, dtype):
    """f32 throughout; sums over Ta keys in another order."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((B, H, M, hd), generator=g, device=cuda).to(dtype)
    k8, v8 = (torch.randint(-127, 128, (B, H, hd, Ta), generator=g,
                            device=cuda, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((B, H, 1, 1), generator=g, device=cuda) * 0.015
              + 0.005 for _ in range(2))
    got = _launched("decode_cross_attention_q8",
                    lambda: K.decode_cross_attention_q8(q, k8, v8, ks, vs))
    ref = K.decode_cross_attention_q8_plain(q, k8, v8, ks, vs)
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-5)
