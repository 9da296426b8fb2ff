"""The port's OTA MAC — kernel 3's plain version, the wrapper's CPU route
and ``ota_aggregate_op`` — against the JAX package's Pallas kernel (in
interpret mode), its jnp oracle and its op, on identical numpy inputs."""
import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import ota_aggregate_op as jax_ota_op
from repro.kernels.ota_aggregate import ota_aggregate as jax_ota
from repro.kernels.ref import ota_aggregate_ref as jax_ota_ref
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ota_aggregate as omod
from repro_torch.kernels.ops import ota_aggregate_op
from repro_torch.kernels.ota_aggregate import ota_aggregate
from repro_torch.kernels.ref import ota_aggregate_ref
from repro_torch.utils.pytree import tree_leaves, tree_size

# The JAX package's own tolerances for kernel 3 (tests/test_kernels.py):
# f32 sums in another order; bf16 outputs.
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# JAX's tier-1 shapes for kernel 3, aligned and ragged; then more than 16
# rows in one call: decentralized consensus (C = K), rows in blocks of 4,
# and two passes of 64 rows.
SHAPES = [(8, 2, 512), (12, 3, 257), (8, 3, 1337), (5, 2, 700),
          (50, 50, 1337), (40, 20, 3001), (128, 128, 515)]
PORTS = {"ref": ota_aggregate_ref, "cpu_route": ota_aggregate}


def _inputs(K, C, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, d)).astype(np.float32),
            rng.uniform(size=(C, K)).astype(np.float32),
            (0.1 * rng.standard_normal((C, d))).astype(np.float32))


def _as(dtype, *arrays):
    """The arrays in ``dtype`` for both packages (both round to nearest
    even from f32, so they hold the same bits)."""
    return ([jnp.asarray(a).astype(getattr(jnp, d)) for a, d in
             zip(arrays, dtype)],
            [torch.from_numpy(a).to(getattr(torch, d)) for a, d in
             zip(arrays, dtype)])


@pytest.mark.parametrize("K,C,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("port", sorted(PORTS))
def test_ota_aggregate_matches_jax(K, C, d, dtype, port):
    """Weights and noise in the signals' dtype, as JAX's tests pass them;
    held against JAX's kernel (tile 256: several tiles, a ragged last one)
    and its oracle."""
    (js, jw, jn), (ts, tw, tn) = _as([dtype] * 3,
                                     *_inputs(K, C, d, K + C + d))
    got = PORTS[port](ts, tw, tn)
    assert got.dtype == getattr(torch, dtype) and got.shape == (C, d)
    for ref in (jax_ota(js, jw, jn, tile=256), jax_ota_ref(js, jw, jn)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("port", sorted(PORTS))
def test_ota_aggregate_bf16_signals_f32_noise_match_jax(port):
    """bf16 signals with f32 weights and noise (the kernel's mixed
    instantiation); the output is bf16."""
    (js, jw, jn), (ts, tw, tn) = _as(["bfloat16", "float32", "float32"],
                                     *_inputs(8, 3, 1337, 1))
    got = PORTS[port](ts, tw, tn)
    assert got.dtype == torch.bfloat16
    for ref in (jax_ota(js, jw, jn, tile=256), jax_ota_ref(js, jw, jn)):
        assert ref.dtype == jnp.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


@pytest.mark.parametrize("port", sorted(PORTS))
def test_ota_aggregate_one_hot_is_exact(port):
    """Zero noise and one-hot weights at a ragged d give back the selected
    rows bit for bit, the last elements included (JAX's exact case)."""
    K, C, d, pick = 6, 3, 1000, [0, 3, 5]
    s = np.random.default_rng(24).standard_normal((K, d)).astype(np.float32)
    w = np.eye(K, dtype=np.float32)[pick]
    got = PORTS[port](torch.from_numpy(s), torch.from_numpy(w),
                      torch.zeros(C, d)).numpy()
    np.testing.assert_array_equal(got, s[pick])
    ref = jax_ota(jnp.asarray(s), jnp.asarray(w), jnp.zeros((C, d)),
                  tile=256)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("port", sorted(PORTS))
def test_ota_aggregate_is_linear(port):
    """Without noise the MAC is linear: y(a + b) = y(a) + y(b), to JAX's
    tolerance for the same check."""
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.standard_normal((10, 777)).astype(
        np.float32)) for _ in range(2))
    w = torch.from_numpy(rng.uniform(size=(3, 10)).astype(np.float32))
    zero = torch.zeros(3, 777)
    fn = PORTS[port]
    np.testing.assert_allclose((fn(a, w, zero) + fn(b, w, zero)).numpy(),
                               fn(a + b, w, zero).numpy(), atol=1e-4)


@pytest.mark.parametrize("bad,err,match", [
    ("signals_1d", ValueError, r"\(K, d\)"),
    ("weights_shape", ValueError, "weights must be"),
    ("noise_shape", ValueError, "noise must be"),
    ("empty", ValueError, "at least 1"),
    ("signals_f16", TypeError, "signals must be"),
    ("weights_int", TypeError, "weights must be floating"),
    ("noise_bf16_for_f32", TypeError, "noise must be"),
    ("weights_meta", ValueError, "weights is on meta"),
    ("all_meta", ValueError, "CUDA or the CPU"),
])
def test_ota_aggregate_rejects_bad_inputs(bad, err, match):
    s, w, n = (torch.from_numpy(a) for a in _inputs(4, 2, 16, 0))
    args = {"signals_1d": (s[0], w, n), "weights_shape": (s, w[:, :3], n),
            "noise_shape": (s, w, n[:, :8]),
            "empty": (s[:, :0], w, n[:, :0]),
            "signals_f16": (s.half(), w, n), "weights_int": (s, w.int(), n),
            "noise_bf16_for_f32": (s, w, n.bfloat16()),
            "weights_meta": (s, w.to("meta"), n),
            "all_meta": (s.to("meta"), w.to("meta"), n.to("meta"))}[bad]
    with pytest.raises(err, match=match):
        ota_aggregate(*args)


def test_cpu_route_launches_no_kernel():
    """On the CPU the wrapper runs the plain version and counts nothing."""
    ota_aggregate(*(torch.from_numpy(a) for a in _inputs(8, 3, 300, 5)))
    ota_aggregate_op({"w": torch.ones(4, 3, 2)}, torch.eye(4)[:2],
                     torch.zeros(2, 6), 0.1)
    assert omod.launches == 0


def _stacked_tree(K, seed):
    """A K-stacked tree whose sorted leaf order (fc0, fc1, fc10) differs
    from the numeric one."""
    rng = np.random.default_rng(seed)
    shapes = {"fc0": (5, 3), "fc1": (3, 4), "fc10": (4, 2)}
    return {name: {"w": rng.standard_normal((K,) + s).astype(np.float32),
                   "b": rng.standard_normal((K, s[1])).astype(np.float32)}
            for name, s in shapes.items()}


@pytest.mark.parametrize("noise_std", [0.0, 0.1])
def test_ota_aggregate_op_matches_jax(noise_std):
    """Pytree in, per-cluster pytree out, with JAX's normals
    (``normal(noise_key, (C, d))``) replayed."""
    K, C = 4, 2
    stacked = _stacked_tree(K, 0)
    w = np.random.default_rng(1).uniform(size=(C, K)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    ref = jax_ota_op(jax.tree.map(jnp.asarray, stacked), jnp.asarray(w),
                     key, noise_std)
    d = sum(x[0].size for x in jax.tree.leaves(stacked))
    unit = torch.from_numpy(np.array(jax.random.normal(key, (C, d),
                                                       jnp.float32)))
    got = ota_aggregate_op(params_from_jax(stacked, device="cpu"),
                           torch.from_numpy(w), unit, noise_std)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(ref)):
        assert tuple(a.shape) == b.shape and b.shape[0] == C
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


def test_ota_aggregate_op_one_hot_round_trip():
    """Zero noise and one-hot weights reproduce the selected client's
    params, leaf for leaf (JAX's round-trip case)."""
    stacked = params_from_jax(_stacked_tree(4, 3), device="cpu")
    out = ota_aggregate_op(stacked, torch.eye(4)[[1, 3]],
                           torch.zeros(2, tree_size(stacked) // 4), 0.0)
    for a, b in zip(tree_leaves(out), tree_leaves(stacked)):
        assert torch.equal(a, b[[1, 3]])


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """The kernel's launch plan (``csrc/ota_plan.h``, plain C++) built
    alone with the host's C++ compiler: the plan the card launches by."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the plan header with")
    d = tmp_path_factory.mktemp("ota_plan")
    (d / "plan.cpp").write_text(f'#include "{omod.PLAN_HEADER}"\n')
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-o", str(d / "plan.so"), str(d / "plan.cpp")],
                   check=True)
    return ctypes.CDLL(str(d / "plan.so"))


def _plan(lib, K, C, d, dtype=torch.float32, noise_dtype=torch.float32):
    return omod.read_plan(lib, K, C, d, dtype, noise_dtype, 132)


def test_launch_plan_raises_beyond_one_launch(plan_lib):
    """The kernel's range: any C and K with C·K < 2^31 (the weights'
    elements) in one launch, decentralized consensus past 256 clients and
    FedAvg past 1,000 included; beyond it the plan refuses, and the CUDA
    route raises that as a ValueError with its message."""
    for K, C in ((2000, 1), (300, 300), (1000, 257), (1001, 16),
                 (60000, 1), (3700, 3700)):
        p = _plan(plan_lib, K, C, 777)
        assert p is not None and p.grid >= 1, (K, C)
    for K, C in ((46341, 46341), (1 << 16, 1 << 15), (0, 3), (50, 0)):
        assert _plan(plan_lib, K, C, 777) is None, (K, C)
    assert _plan(plan_lib, 50, 3, 1 << 40) is None
    err = omod.launch_error(-1, 46341, 46341, 777)
    assert isinstance(err, ValueError) and "in one launch" in str(err)
    assert isinstance(omod.launch_error(700, 50, 3, 777), RuntimeError)


@pytest.mark.parametrize("dtype,noise_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("K", [1, 16, 50, 128, 200, 1000])
def test_launch_plan_fits_and_covers(plan_lib, K, dtype, noise_dtype):
    """For every row count: C <= 8 (with W in a block's shared memory)
    takes the column path (blocks of 256 threads, one column a thread, C
    rows of W in shared memory), more the ring (a tile of one
    16-byte vector a lane, a row block of at most 32 sums a lane, shared
    memory within a block's and an SM's, room for two stages of S and N);
    either grid covers d with its ragged edge."""
    elem, n_elem = dtype.itemsize, noise_dtype.itemsize
    for C in sorted({1, 3, 16, 17, 50, K}):
        for d in (1, 127, 129, 184214):
            p = _plan(plan_lib, K, C, d, dtype, noise_dtype)
            assert p.tiles * p.tile >= d > (p.tiles - 1) * p.tile
            assert p.ring == (C > 8 or 4 * C * K > 232448)
            if not p.ring:
                assert (p.rows, p.tile, p.grid) == (C, 256, p.tiles)
                assert p.warps * 32 == 256
                assert p.smem_bytes == 4 * C * K
                continue
            assert p.tile * elem == 32 * 16
            assert p.rows in (2, 4, 8) and p.rows * 16 // elem <= 32
            # R spreads the rows over the warps before it grows; an SM
            # runs 16 warps of the ring (128 registers a thread) or, at
            # R = 8, one block of 8.
            assert p.rows == 2 or (p.rows // 2) * p.warps < C
            assert p.warps in (8, 16) and p.blocks_per_sm * p.warps <= 16
            assert p.warps == 8 or (p.k_chunk == 0 and p.rows * 16 >= C)
            assert p.smem_bytes <= 232448
            assert p.blocks_per_sm * (p.smem_bytes + 1024) <= 233472
            assert p.blocks_per_sm == 1 or p.rows < 8
            # Two stages of what a block reads for an item: the tile's K
            # rows of S and C rows of N (then W beside them), or a chunk of
            # S, W and N for one pass of warps x R rows.
            s_row, n_row = p.tile * elem, p.tile * n_elem
            if p.k_chunk == 0:
                assert p.passes == 1
                assert p.smem_bytes >= (2 * (K * s_row + C * n_row)
                                        + 4 * C * K)
            else:
                rows = p.warps * p.rows
                assert p.k_chunk % 4 == 0 and 4 <= p.k_chunk <= 64
                assert p.passes == -(-C // rows)
                assert p.smem_bytes >= 2 * (p.k_chunk * (s_row + 4 * rows)
                                            + rows * n_row)
            assert 1 <= p.grid <= min(p.tiles, p.blocks_per_sm * 132)


def test_launch_plan_of_the_trainers_shapes(plan_lib):
    """The shapes the trainer and the dist path give the kernel at the
    paper's width: C = 1 and 3 on the column path (720 blocks of 256
    columns); C = K = 50 on the ring with S resident (the tile's whole K
    and its 50 rows of N in a stage, W staged once a block), one block of
    16 warps an SM, 4 rows a warp; C = K = 128 streams K in chunks of 64,
    once for each of its two passes of 64 rows."""
    f32, bf16 = torch.float32, torch.bfloat16
    for C, dtype, noise_dtype in ((1, f32, f32), (3, f32, f32),
                                  (3, bf16, bf16), (3, bf16, f32)):
        p = _plan(plan_lib, 50, C, 184214, dtype, noise_dtype)
        assert not p.ring and p.grid == 720
    p = _plan(plan_lib, 50, 50, 184214)
    assert p.ring and p.k_chunk == 0 and (p.warps, p.rows) == (16, 4)
    assert (p.blocks_per_sm, p.grid) == (1, 132)
    p = _plan(plan_lib, 128, 128, 184214)
    assert p.ring and (p.rows, p.k_chunk, p.passes) == (8, 64, 2)
