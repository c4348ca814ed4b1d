"""The activation quantize step of the PyTorch port (``ops/quantize.py``,
``models/quant.py::_quantize_act``) on the CPU: the plain version against
the JAX package's expression, the wrapper's refusals, the layouts it
reads, and the entry off the card. The kernel itself (``csrc/quantize.cu``)
runs only on a card: ``chip_smoke.py``'s ``kernels: quantize`` lines hold
it against the plain version there, bit for bit.

Tolerance: none. Both sides widen to float32, divide exactly, round half to
even, clip and cast, so every int8 value must be equal, the edges included
(ties, +-0, +-inf, NaN, the largest bfloat16, subnormals, values past
+-127 xs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from playground3d_tpu_torch.models import quant as PQ
from playground3d_tpu_torch.ops import quantize as Q

torch.set_num_threads(1)

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float32": (torch.float32, jnp.float32)}
N_VALUES = 96  # one array length, so JAX compiles each op once


def _jax_quantize(x: torch.Tensor, xs: float, jdtype) -> np.ndarray:
    """The JAX package's expression (``playground3d_tpu/models/quant.py:140``)
    on the same values: ``x`` widened exactly to float32, cast back to its
    dtype in JAX."""
    a = jnp.asarray(x.to(torch.float32).numpy()).astype(jdtype)
    return np.asarray(jnp.clip(jnp.round(a.astype(jnp.float32) / jnp.asarray(np.float32(xs))), -127.0, 127.0)
                      .astype(jnp.int8))


def _padded(values: list, dtype: torch.dtype) -> torch.Tensor:
    v = (list(values) * (N_VALUES // max(len(values), 1) + 1))[:N_VALUES]
    return torch.tensor(v, dtype=torch.float32).to(dtype)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("xs", [0.0625, 0.043, 1.0, 7.874015748031496e-11, 3.0517578125e-05, 255.0 / 127.0])
def test_plain_quantize_equals_jax_at_the_edges(name, xs):
    """The edges at a few scales: powers of two (the ties stay exact in
    bfloat16), the calibration's smallest scale (1e-8 / 127) and ordinary
    ones."""
    dtype, jdtype = DTYPES[name]
    x = _padded(Q.edge_values(xs), dtype)
    xs_t = torch.tensor(xs, dtype=torch.float32)
    got = Q.quantize_plain(x, xs_t)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), _jax_quantize(x, xs, jdtype))
    assert torch.equal(PQ._quantize_act(x, xs_t), got)


_FLOATS = st.floats(width=32, allow_nan=True, allow_infinity=True)
_SCALES = st.floats(min_value=float(np.float32(1e-10)), max_value=1e4, width=32, allow_subnormal=False)


@settings(max_examples=150, deadline=None, database=None)
@given(name=st.sampled_from(sorted(DTYPES)), xs=_SCALES,
       multiples=st.lists(st.floats(min_value=-140.0, max_value=140.0, width=32), min_size=1, max_size=N_VALUES),
       raw=st.lists(_FLOATS, min_size=0, max_size=16))
def test_plain_quantize_equals_jax_on_drawn_values(name, xs, multiples, raw):
    """Drawn scales and values: multiples of the scale around the clip
    (half-integers often, after rounding to the dtype), any float32, and the
    edges."""
    dtype, jdtype = DTYPES[name]
    x = _padded([m * xs for m in multiples] + raw + Q.edge_values(xs)[:8], dtype)
    got = Q.quantize_plain(x, torch.tensor(xs, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), _jax_quantize(x, xs, jdtype))


def test_quantize_act_keeps_a_channels_last_layout():
    """The quantize step of an NCHW view of channels-last memory gives int8
    in the same layout (the int8 conv then reads it as NHWC without a
    copy)."""
    x = torch.randn(2, 16, 5, 7).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    q = PQ._quantize_act(x, torch.tensor(0.02))
    assert q.stride() == x.stride() and q.permute(0, 2, 3, 1).is_contiguous()
    assert torch.equal(q, Q.quantize_plain(x.contiguous(), torch.tensor(0.02)))


_LAYOUTS = {
    "contiguous": (lambda t: t, True),
    "channels-last": (lambda t: t.contiguous(memory_format=torch.channels_last), True),
    "flat": (lambda t: t.reshape(-1), True),
    "offset": (lambda t: t.reshape(-1)[1:], True),  # unaligned: the kernel's tail loop takes it
    "size-1 dims": (lambda t: t.reshape(2, 120)[:, None], True),
    "empty": (lambda t: t[:, :0], True),
    "transpose": (lambda t: t.transpose(1, 2), False),
    "gaps": (lambda t: t[:, ::2], False),
    "broadcast": (lambda t: t[:1].expand(2, 8, 3, 5), False),
}


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_is_dense(layout):
    """The kernel reads the two layouts the nets give, contiguous and
    channels-last, whatever the shape; any other view is not dense."""
    view, dense = _LAYOUTS[layout]
    assert Q.is_dense(view(torch.zeros((2, 8, 3, 5)))) is dense


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16, torch.float64])
def test_the_entry_runs_the_plain_version_off_the_card(dtype, layout):
    """Off the card every input takes the plain ops, in its own layout,
    and nothing counts: the tally counts launches on a card."""
    launches = Q.quantize_cuda.launches
    x = _LAYOUTS[layout][0](torch.linspace(-9, 9, 240).reshape(2, 8, 3, 5).to(dtype))
    got = Q.quantize(x, torch.tensor(0.03))
    assert torch.equal(got, Q.quantize_plain(x, torch.tensor(0.03))) and got.shape == x.shape
    assert Q.quantize_cuda.launches == launches


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"),
    ("channels_last_cpu", "CUDA"),
    ("float16", "bfloat16 or float32"),
    ("int8", "bfloat16 or float32"),
    ("gaps", "contiguous or channels-last"),
    ("broadcast", "contiguous or channels-last"),
    ("transpose", "contiguous or channels-last"),
    ("xs_float64", "float32 scalar"),
    ("xs_vector", "float32 scalar"),
    ("xs_other_device", "xs is on meta"),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    x = torch.zeros((2, 8, 3, 5), dtype=torch.bfloat16)
    xs = torch.tensor(0.5)
    args = {
        "cpu": (x, xs),
        "channels_last_cpu": (x.contiguous(memory_format=torch.channels_last), xs),
        "float16": (x.half(), xs),
        "int8": (x.to(torch.int8), xs),
        "gaps": (x[:, ::2], xs),
        "broadcast": (torch.zeros(1, 8, 3, 5, dtype=torch.bfloat16).expand(2, 8, 3, 5), xs),
        "transpose": (x.transpose(1, 2), xs),
        "xs_float64": (x, xs.double()),
        "xs_vector": (x, xs.reshape(1)),
        "xs_other_device": (x, xs.to("meta")),
    }[case]
    with pytest.raises(ValueError, match=match):
        Q.quantize_cuda(*args)


def test_the_kernel_source_exports_what_the_wrapper_binds():
    src = Q.LIB.source.read_text()
    assert "int quantize_int8(const void* x, void* out, const void* xs, long long n, int is_bf16, void* stream)" in src
    header = (Q.LIB.source.parent / "int8_round.cuh").read_text()
    assert "__fdiv_rn(v, xs)" in header and "rintf(" in header and "-127" in header


@pytest.mark.parametrize("source", ["quantize.cu", "qconv.cu"])
def test_the_int8_rounding_lives_in_one_header(source):
    """``quantize.cu`` and ``qconv.cu``'s epilogue round to int8 through
    ``int8_round.cuh``; neither keeps a copy of its own."""
    text = (Q.LIB.source.parent / source).read_text()
    assert '#include "int8_round.cuh"' in text
    assert "__fdiv_rn" not in text and "12582912" not in text and "0.4999" not in text


def test_an_edited_header_builds_anew(tmp_path, monkeypatch):
    """The build's digest covers the ``*.cuh`` headers beside a source, so
    an edited header does not reuse a library built before the edit."""
    import sys

    from playground3d_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "k.cu").write_text('#include "r.cuh"\n')
    (tmp_path / "r.cuh").write_text("// one\n")
    cmd = [sys.executable, "-c", "import sys; open(sys.argv[2], 'w').write('lib')"]  # writes the -o file
    first, _ = cuda_build.build_library("k", tmp_path / "k.cu", cmd)
    assert cuda_build.build_library("k", tmp_path / "k.cu", cmd) == (first, "")
    (tmp_path / "r.cuh").write_text("// two\n")
    second, _ = cuda_build.build_library("k", tmp_path / "k.cu", cmd)
    assert second != first and first.exists() and second.exists()


def _kernel_model(x: torch.Tensor, xs: float) -> "tuple[np.ndarray, np.ndarray]":
    """``csrc/quantize.cu``'s arithmetic (its rounding is ``int8_round.cuh``)
    in numpy float32, each operation rounded as the card rounds it: the
    guess from ``fl(v * fl(1 / xs))`` by the 1.5 * 2^23 addition, and the
    exact division where the guess may be wrong -> (int8 values, which
    values took the division)."""
    v = x.to(torch.float32).numpy()
    s = np.float32(xs)
    with np.errstate(all="ignore"):
        inv = np.float32(1) / s
        tiny = np.finfo(np.float32).tiny
        fast = abs(s) >= tiny and abs(inv) >= tiny and np.isfinite(inv)
        magic = np.float32(12582912.0)
        q = (v * inv).astype(np.float32)
        clamped = np.where(np.isnan(q), np.float32(-128), np.clip(q, -128, 128)).astype(np.float32)  # fmaxf drops NaN
        big = (clamped + magic).astype(np.float32)
        guess = np.clip(big.view(np.int32) - 0x4B400000, -127, 127)
        exact = ~((np.abs(q) >= 126.75) | (np.abs((q - (big - magic)).astype(np.float32)) <= np.float32(0.4999)))
        if not fast:
            exact[:] = True
        t = (v / s).astype(np.float32)
        division = np.where(np.isnan(t), 0, np.rint(np.clip(np.nan_to_num(t, nan=0.0), -127, 127)))
    return np.where(exact, division, guess).astype(np.int8), exact


@settings(max_examples=300, deadline=None, database=None)
@given(name=st.sampled_from(sorted(DTYPES)), xs=st.one_of(_SCALES, _FLOATS),
       multiples=st.lists(st.floats(min_value=-140.0, max_value=140.0, width=32), min_size=1, max_size=N_VALUES),
       raw=st.lists(_FLOATS, min_size=0, max_size=16))
def test_the_kernels_division_free_guess_gives_the_plain_bits(name, xs, multiples, raw):
    """The kernel divides only where its guess from the reciprocal may
    round otherwise: the model of its arithmetic equals the plain version
    on drawn values at any scale (zero, negative, subnormal, inf and NaN
    scales take the division everywhere)."""
    dtype, _ = DTYPES[name]
    x = _padded([m * xs for m in multiples] + raw + Q.edge_values(xs), dtype)
    got, _ = _kernel_model(x, xs)
    np.testing.assert_array_equal(got, Q.quantize_plain(x, torch.tensor(xs, dtype=torch.float32)).numpy())


def test_the_kernel_divides_rarely_on_activations():
    """On values spread like activations (a ReLU's zeros among them) about
    one in a thousand takes the exact division."""
    gen = torch.Generator().manual_seed(3)
    x = torch.relu(torch.randn(1 << 16, generator=gen) * 2).to(torch.bfloat16)
    got, exact = _kernel_model(x, 0.043)
    np.testing.assert_array_equal(got, Q.quantize_plain(x, torch.tensor(0.043)).numpy())
    assert exact.mean() < 2e-3
