"""The flushed f32 add's launch (``repro_torch.kernels.xla_add``) on the CPU.

``launch_geometry`` and ``index_spans`` model the kernel's grid and index
map (``csrc/xla_add.cu``, a grid-stride loop): on both routes, at sizes
around one block's span and the loop's stride, the few-element cases and
SmolLM-135M's leaf sizes, the map covers every element exactly once. The wrapper's launch is driven against a
stand-in for the C entry point: no launch at 0 elements, one launch
counted on the route the pointers' alignment names otherwise. The
kernel's arithmetic, applied span by span, is held to the reference's
XLA add on the CPU. The kernel itself runs on the card
(``tests/test_torch_cuda.py::test_xla_add_kernel_bitwise_vs_plain``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, xla_add

#: One block's span in one trip of its loop on the vector route (elements)
#: and on the scalar route, and the loop's stride, the largest grid's span.
VECTOR_SPAN = xla_add.THREADS * xla_add.VECTOR
SCALAR_SPAN = xla_add.THREADS
VECTOR_STRIDE = xla_add.MAX_BLOCKS * VECTOR_SPAN
SCALAR_STRIDE = xla_add.MAX_BLOCKS * SCALAR_SPAN
#: The leaf sizes of SmolLM-135M that the delta publisher adds.
LEAF_SIZES = (28311552, 26542080, 9953280, 3317760, 17280, 576)
SIZES = sorted({0, 1, 3, 4, 5, VECTOR_SPAN - 1, VECTOR_SPAN, VECTOR_SPAN + 1,
                VECTOR_SPAN + 3, SCALAR_SPAN - 1, SCALAR_SPAN,
                SCALAR_SPAN + 1, VECTOR_STRIDE - 1, VECTOR_STRIDE,
                VECTOR_STRIDE + 5, SCALAR_STRIDE - 1, SCALAR_STRIDE,
                SCALAR_STRIDE + 1, *LEAF_SIZES})


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", SIZES)
def test_index_map_covers_every_element_once(n, aligned):
    spans = xla_add.index_spans(n, aligned)
    geo = xla_add.launch_geometry(n, aligned)
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    assert (spans[:, 0] < spans[:, 1]).all()
    if n == 0:
        assert spans.shape == (0, 2) and geo["blocks"] == 0
        return
    assert spans[0, 0] == 0 and spans[-1, 1] == n
    assert np.array_equal(spans[1:, 0], spans[:-1, 1])  # no gap, no overlap
    assert geo["route"] == ("vector" if aligned else "scalar")
    # every block owns work in its first trip, up to the largest grid,
    # and no thread takes more trips than items
    span = SCALAR_SPAN * geo["unit_elems"]
    assert geo["blocks"] == min(max(1, -(-(n - geo["tail"]) // span)),
                                xla_add.MAX_BLOCKS)
    assert geo["items"] * geo["blocks"] * span >= n - geo["tail"]
    assert (geo["items"] - 1) * geo["blocks"] * span < max(n - geo["tail"],
                                                           1)


def test_launch_geometry_at_the_embed_leaf():
    geo = xla_add.launch_geometry(28311552, True)
    assert geo == {"route": "vector", "units": 7077888, "unit_elems": 4,
                   "tail": 0, "blocks": 2112, "threads": 256, "items": 14}
    assert xla_add.launch_geometry(5, True)["tail"] == 1
    assert xla_add.launch_geometry(5, False)["tail"] == 0


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("subtract", [False, True])
def test_the_index_map_with_the_kernels_add_equals_the_reference(aligned,
                                                                   subtract):
    """Each span's elements through the kernel's arithmetic (XLA's add,
    here its plain version) make the reference's ``a - b`` / ``a + b``."""
    rng = np.random.default_rng(7)
    n = 2 * VECTOR_SPAN + 7
    x = rng.standard_normal((2, n)).astype(np.float32)
    x[:, ::9] = np.float32([[1e-40], [-1.5e-38]])
    a, b = torch.from_numpy(x[0]), torch.from_numpy(x[1])
    out = torch.full((n,), float("nan"))
    for lo, hi in xla_add.index_spans(n, aligned):
        out[lo:hi] = xla_add.xla_add_plain(a[lo:hi], b[lo:hi],
                                           subtract=subtract)
    ja, jb = jnp.asarray(x[0]), jnp.asarray(x[1])
    want = np.asarray(ja - jb if subtract else ja + jb)
    assert out.numpy().tobytes() == want.tobytes()


@pytest.fixture
def fake_entry(monkeypatch):
    """The C entry point replaced by a recorder that returns success."""
    calls = []

    def entry(lib, symbol, argtypes):
        assert (lib, symbol) == ("xla_add", "spk_xla_add")
        assert len(argtypes) == 9
        return lambda *args: calls.append(args) or 0

    monkeypatch.setattr(_build, "entry", entry)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    return calls


def test_no_launch_at_zero_elements(fake_entry):
    before = (xla_add.xla_add_raw.launches,
              dict(xla_add.xla_add_raw.routes))
    empty = torch.empty(0)
    xla_add._launch(empty, empty, torch.empty(0), subtract=True)
    assert fake_entry == []
    assert (xla_add.xla_add_raw.launches,
            dict(xla_add.xla_add_raw.routes)) == before


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_launch_takes_the_route_of_the_alignment(fake_entry, offset):
    n = VECTOR_SPAN + 5
    base = torch.empty(n + 4)
    assert base.data_ptr() % 16 == 0
    a = base[offset:offset + n]
    b, out = torch.empty(n), torch.empty(n)
    launches = xla_add.xla_add_raw.launches
    routes = dict(xla_add.xla_add_raw.routes)
    xla_add._launch(a, b, out, subtract=False)
    route = "vector" if offset == 0 else "scalar"
    geo = xla_add.launch_geometry(n, offset == 0)
    (args,) = fake_entry
    assert args[3:7] == (n, 0, int(offset == 0), geo["blocks"])
    assert xla_add.xla_add_raw.launches == launches + 1
    assert xla_add.xla_add_raw.routes == {
        **routes, route: routes[route] + 1}


def test_cpu_tensors_take_the_plain_version(fake_entry):
    launches = xla_add.xla_add_raw.launches
    out = xla_add.xla_add_raw(torch.ones(9), torch.full((9,), 1e-40),
                              subtract=True)
    assert fake_entry == [] and xla_add.xla_add_raw.launches == launches
    assert torch.equal(out, torch.ones(9))
