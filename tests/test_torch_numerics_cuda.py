"""The port's numerics on a card: bf16 products rounded to bf16 once (after
the f32 bias), the f32 convolution in full f32 under PyTorch's default
TF32 switches, and no process-wide ``torch.backends`` switch set by the
port. Every test here is marked ``cuda`` and skips without one.

The references are computed in float64 on the CPU. A bf16 result may
differ from the float64 value by half a bf16 ulp (its one rounding) plus
the error of an f32 sum of n terms, at most n·2⁻²⁴·Σ|terms|; an f32 result
by half an f32 ulp plus the same sum error. Run on the card as
``tests/test_torch_kernels_cuda.py`` says (``--noconftest -m cuda``).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from audio_rag_tpu_torch.models import layers as L
from audio_rag_tpu_torch.models import whisper as tw

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
U = 2.0 ** -24  # f32 unit roundoff


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64) * scale


def _ulp(v, bits):
    """Spacing of a float with ``bits`` significant bits at |v|."""
    e = torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -126)))
    return torch.pow(2.0, e - (bits - 1))


def _check(got, exact, terms, mag, bits):
    """|got − exact| ≤ ½ ulp (``bits`` significant bits) + the f32 sum
    error of ``terms`` terms of total magnitude ``mag``."""
    sum_err = terms * U * mag
    tol = 0.5 * _ulp(exact.abs() + sum_err, bits) + sum_err
    err = (got.double().cpu() - exact).abs()
    bad = err > tol
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {bad.numel()} outside the bound; worst "
        f"excess {float((err - tol).max()):.3e}")


def _linear_case(B, din, dout, seed):
    x = _randn((B, din), seed)
    w = _randn((din, dout), seed + 1, din ** -0.5)
    b = _randn((dout,), seed + 2)  # the size of x·w: sums that cancel
    return x, w, b


@pytest.mark.parametrize("B,din,dout", [
    (64, 128, 128),     # tiny-synth's width
    (48, 1280, 1280),   # large-v3's
    (16, 1280, 5120),
])
def test_bf16_linear_rounds_once(cuda, B, din, dout):
    x, w, b = _linear_case(B, din, dout, 3)
    xb, wb = x.bfloat16(), w.bfloat16()
    p = {"w": wb.to(cuda), "b": b.float().to(cuda)}
    got = L.linear(p, xb.to(cuda), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    xd, wd = xb.double(), wb.double()
    exact = xd @ wd + b.float().double()
    mag = xd.abs() @ wd.abs() + b.float().double().abs()
    _check(got, exact, din + 1, mag, 8)


def _conv_ref(x, w, b, stride):
    """The port's kernel-3 "SAME" convolution in float64: x (B, T, Cin),
    w (3, Cin, Cout), b (Cout,) → (B, T', Cout), and Σ|x·w| + |b|."""
    T = x.shape[1]
    out_len = -(-T // stride)
    pad = max((out_len - 1) * stride + 3 - T, 0)

    def conv(xx, ww):
        xc = F.pad(xx.transpose(1, 2), (pad // 2, pad - pad // 2))
        return F.conv1d(xc, ww.permute(2, 1, 0), stride=stride) \
            .transpose(1, 2)

    return conv(x, w) + b, conv(x.abs(), w.abs()) + b.abs()


@pytest.mark.parametrize("B,T,cin,cout,stride", [
    (4, 600, 128, 128, 1),    # tiny-synth: conv1, conv2
    (4, 600, 128, 128, 2),
    (2, 3000, 128, 1280, 1),  # large-v3: conv1, conv2
    (2, 3000, 1280, 1280, 2),
    (3, 37, 40, 24, 2),       # odd T
])
def test_bf16_conv1d_rounds_once(cuda, B, T, cin, cout, stride):
    x = _randn((B, T, cin), 5)
    w = _randn((3, cin, cout), 6, (3 * cin) ** -0.5)
    b = _randn((cout,), 7)
    xb, wb, bf = x.bfloat16(), w.bfloat16(), b.float()
    p = {"w": wb.to(cuda), "b": bf.to(cuda)}
    got = tw._conv1d(p, xb.to(cuda), stride, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    exact, mag = _conv_ref(xb.double(), wb.double(), bf.double(), stride)
    assert got.shape == exact.shape
    _check(got, exact, 3 * cin + 1, mag, 8)


@pytest.mark.parametrize("B,T,cin,cout,stride", [
    (4, 600, 128, 128, 1),
    (2, 3000, 128, 1280, 1),
    (2, 1500, 1280, 1280, 2),
])
def test_f32_conv1d_is_full_f32_under_default_switches(cuda, B, T, cin,
                                                       cout, stride):
    """cuDNN runs f32 convolutions in TF32 while
    ``torch.backends.cudnn.allow_tf32`` is True, PyTorch's default; the
    port's convolution stays f32 without touching the switch."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        x = _randn((B, T, cin), 8)
        w = _randn((3, cin, cout), 9, (3 * cin) ** -0.5)
        b = _randn((cout,), 10)
        xf, wf, bf = x.float(), w.float(), b.float()
        p = {"w": wf.to(cuda), "b": bf.to(cuda)}
        got = tw._conv1d(p, xf.to(cuda), stride, torch.float32)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    exact, mag = _conv_ref(xf.double(), wf.double(), bf.double(), stride)
    _check(got, exact, 3 * cin + 1, mag, 24)


def _switches():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


def _encode_small(device, dtype):
    dims = tw.WHISPER_PRESETS["tiny-synth"]
    params = tw.init_whisper(dims, seed=0, device=device, dtype=dtype)
    g = torch.Generator(device=device).manual_seed(0)
    mel = torch.randn((2, dims.n_mels, 2 * dims.n_audio_ctx), generator=g,
                      device=device)
    out = tw.encode(params, dims, mel, dtype)
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("matmul_tf32,cudnn_tf32", [
    (False, True),  # PyTorch's defaults
    (True, False),
])
def test_encode_leaves_the_tf32_switches_as_they_were(cuda, matmul_tf32,
                                                      cudnn_tf32):
    saved = _switches()
    try:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        before = _switches()
        for dtype in (torch.float32, torch.bfloat16):
            assert torch.isfinite(_encode_small(cuda, dtype).float()).all()
            assert _switches() == before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def test_importing_the_port_and_encoding_keep_pytorch_defaults(cuda):
    """In a fresh process: PyTorch's own TF32 switches before the port is
    imported, the same after an import and an encode in f32 and bf16."""
    code = f"""
import json, sys, torch
sys.path.insert(0, {str(ROOT)!r})
def switches():
    return [torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision()]
before = switches()
from audio_rag_tpu_torch.models import whisper as tw
mid = switches()
dims = tw.WHISPER_PRESETS["tiny-synth"]
mel = torch.randn((2, dims.n_mels, 2 * dims.n_audio_ctx), device="cuda")
for dtype in (torch.float32, torch.bfloat16):
    params = tw.init_whisper(dims, seed=0, device="cuda", dtype=dtype)
    tw.encode(params, dims, mel, dtype)
torch.cuda.synchronize()
print(json.dumps([before, mid, switches()]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    before, mid, after = json.loads(out.stdout.strip().splitlines()[-1])
    assert before == mid == after


# -- the fallback ladder's PRNG ------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1024), (16, 51866), (80, 51866)])
def test_prng_bits_and_draws_on_card_equal_the_cpus(cuda, shape):
    """``ops/random.py`` on the card: the bits and uniforms of the CPU's
    numpy path bit for bit, the Gumbel noise within 2 ulp of max(|g|, 1)
    (both f64 logs rounded to f32), and the same ``categorical`` draws
    over a chain of keys."""
    from audio_rag_tpu_torch.ops import random as R

    key = R.PRNGKey(40)
    tiny = torch.finfo(torch.float32).tiny
    for _ in range(3):
        key, sub = R.split(key)
        assert torch.equal(R.random_bits(sub, shape, cuda).cpu(),
                           R.random_bits(sub, shape, "cpu"))
        assert torch.equal(R.uniform(sub, shape, tiny, 1.0, cuda).cpu(),
                           R.uniform(sub, shape, tiny, 1.0, "cpu"))
        g_card = R.gumbel(sub, shape, cuda).cpu()
        g_cpu = R.gumbel(sub, shape, "cpu")
        spacing = torch.nextafter(g_cpu.abs().clamp(min=1.0),
                                  torch.tensor(float("inf"))) - \
            g_cpu.abs().clamp(min=1.0)
        assert bool(((g_card - g_cpu).abs() <= 2 * spacing).all())
        logp = torch.log_softmax(_randn(shape, 7).float() * 3.0, dim=-1)
        inv_t = torch.tensor(1.0) / torch.tensor(0.2)
        assert torch.equal(
            R.categorical(sub, (logp * inv_t).to(cuda)).cpu(),
            R.categorical(sub, logp * inv_t))


def test_sampled_greedy_decode_on_card_equals_the_cpus(cuda):
    """Sampled greedy decoding at the ``test`` preset (f32, weights made
    on the host): the card's tokens are the CPU's at 0.2 and 0.4."""
    from audio_rag_tpu_torch.ops import random as R

    dims = tw.WHISPER_PRESETS["test"]
    st = tw.SpecialTokens.for_dims(dims)
    params = tw.init_whisper(dims, seed=0)
    mel = _randn((4, dims.n_mels, 2 * dims.n_audio_ctx), 11).float()
    prompt = torch.tensor([[st.sot, st.lang_base, st.transcribe,
                            st.no_timestamps]] * 4)

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        return tree.to(cuda)

    card = to(params)
    for t in (0.2, 0.4):
        out = []
        for p, dev in ((params, "cpu"), (card, cuda)):
            enc = tw.encode(p, dims, mel.to(dev), torch.float32)
            toks = tw.greedy_decode(p, dims, enc, prompt.to(dev), 8, st.eot,
                                    dtype=torch.float32, temperature=t,
                                    rng=R.PRNGKey(int(t * 100)))[0]
            out.append(toks.cpu())
        assert torch.equal(out[0], out[1])
