"""The port's collectives (``repro_torch.core.collectives``) on 8 CPU ranks
under gloo, against the reference's ``repro.core.collectives`` on 8 forced
host devices, on the same numpy inputs.

The reference runs in one subprocess for the file
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as its own tests
run it); the port's ranks in one ``torch.multiprocessing.spawn`` of 8
(``tests/torch_mesh_workers.py``). The cases are the reference test's
(``test_distributed_reduce.py::test_collectives_cross_check_zeros_and_nan``):
normal, all-zero and NaN-bearing (8, 16) shards.

Tolerances:
  * ring, all-reduce and fixed-order combine against the reference's
    psum: 1e-5 relative, NaN where it has NaN: eight f32 rows summed in
    other orders (the reference's own test holds them at 1e-4 to numpy).
    ``local_mma_then_psum`` (the engine's mma_torch sum of each shard at
    bf16 multipliers, then the all-reduce) within ``harness.budget_for``
    of the total at bf16 compute (observed 3.3e-4 relative). The fixed-order combine against the
    reference's fixed-order combine: BITWISE (the same left fold of the
    same f32 rows).
  * the compressed sum: bitwise the reference's (the same int8
    quantisation, exact int32 sums, one f32 scale), and within 5% of the
    largest sum, the reference's bound; exactly 0 on zeros. Its error carry
    ``x - q scale`` within 1e-6: XLA may fuse the product into the
    subtraction (one rounding where the port has two; observed 1 ulp).
Internal contracts, each with a planted fault: every rank holds the same
bits of the combine; the census agreement is unanimous; the desync
detector sees a per-rank value; one rank's replicated value moved by one
ulp, and one rank's fold moved by one ulp, are reported on EVERY rank.
The meter's received bytes equal ``interconnect_bytes``.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch_mesh_workers as W
from harness import budget_for

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 8


def _cases():
    rng = np.random.RandomState(0)
    cases = {"normal": rng.randn(8, 16).astype(np.float32),
             "zeros": np.zeros((8, 16), np.float32)}
    nanful = rng.randn(8, 16).astype(np.float32)
    nanful[5, 3] = np.nan  # one rank's shard carries the NaN
    cases["nan"] = nanful
    return cases


REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P
from repro.core import collectives as C

cases = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((8,), ("data",))

def body(xs):
    return (C.ring_all_reduce(xs, "data"), C.hierarchical_psum(xs, ("data",)),
            lax.psum(xs, "data"), C.fixed_order_combine(xs, ("data",)))

f = jax.jit(C.shard_map_unchecked(body, mesh=mesh, in_specs=P("data", None),
                                  out_specs=(P("data", None),) * 4))

def cbody(xs, err):
    return C.compressed_psum(xs, "data", err)

cf = jax.jit(C.shard_map_unchecked(cbody, mesh=mesh, in_specs=(P("data", None),) * 2,
                                   out_specs=(P("data", None),) * 2))
out = {}
for name, x in cases.items():
    for key, v in zip(("ring", "hier", "psum", "fo"), f(jnp.asarray(x))):
        out[f"{name}_{key}"] = np.asarray(v)
    if name != "nan":
        q, err = cf(jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)))
        out[f"{name}_compressed"], out[f"{name}_err"] = np.asarray(q), np.asarray(err)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    np.savez(d / "cases.npz", **_cases())
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REF), str(d / "cases.npz"),
                        str(d / "out.npz")], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return W.run("collectives", WORLD, tmp_path_factory.mktemp("ranks"), _cases())


def _stack(ranks, name, key):
    return np.concatenate([r[name][key].numpy() for r in ranks])


@pytest.mark.parametrize("name", ["normal", "zeros", "nan"])
def test_sums_against_reference(ref, ranks, name):
    want = ref[f"{name}_psum"]
    for key in ("ring", "hier"):
        np.testing.assert_allclose(_stack(ranks, name, key), want, rtol=1e-5, atol=1e-6,
                                   equal_nan=True)
    # the engine on each rank's shard, then the all-reduce: the total sum
    x = _cases()[name]
    tol = budget_for(np.nan_to_num(x), "sum", compute_dtype="bfloat16")
    for r in ranks:
        np.testing.assert_allclose(r[name]["local_mma"].numpy(), x.astype(np.float64).sum(),
                                   rtol=0, atol=tol, equal_nan=True)
    fo = _stack(ranks, name, "fo")
    assert fo.tobytes() == ref[f"{name}_fo"].tobytes()  # bitwise the reference's fold


@pytest.mark.parametrize("name", ["normal", "zeros", "nan"])
def test_combine_replicated_and_census_unanimous(ranks, name):
    fo = _stack(ranks, name, "fo")
    assert fo.tobytes() == fo[:1].tobytes() * WORLD
    n_bad = float(np.sum(~np.isfinite(_cases()[name])))
    assert [float(r[name]["combined"][0]) for r in ranks] == [n_bad] * WORLD
    assert all(r[name]["agree"] for r in ranks)
    # the detector flips on a per-rank value, on every rank
    assert not any(r[name]["desync"] for r in ranks)


@pytest.mark.parametrize("name", ["normal", "zeros"])
def test_compressed_sum_against_reference(ref, ranks, name):
    got = _stack(ranks, name, "compressed")
    assert got.tobytes() == ref[f"{name}_compressed"].tobytes()
    np.testing.assert_allclose(_stack(ranks, name, "err"), ref[f"{name}_err"], rtol=0, atol=1e-6)
    psum = ref[f"{name}_psum"]
    if name == "zeros":
        np.testing.assert_array_equal(got, 0.0)
    else:
        assert np.max(np.abs(got - psum)) < 0.05 * np.max(np.abs(psum))
    # the dense grad reduce without its compressed hop is the all-reduce
    np.testing.assert_array_equal(_stack(ranks, name, "grad_reduce"),
                                  _stack(ranks, name, "hier"))


def test_planted_faults_seen_on_every_rank(ranks):
    """One rank's replicated value one ulp off, and one rank's fold one ulp
    off: ``replica_bits_agree`` and ``census_agreement`` report it on all
    ranks (the contracts above would pass them otherwise)."""
    assert [r["fault_bits_agree"] for r in ranks] == [False] * WORLD
    assert [r["fault_census_agree"] for r in ranks] == [False] * WORLD


def test_replica_bits_of_a_0d_bf16_leaf(ranks):
    """A 0-d bf16 tensor (llama-3.2-vision's cross-attention gate) is
    compared as bytes like any 16-bit leaf: equal on every rank, and one
    rank's value one bf16 ulp off seen on all of them."""
    assert [r["gate_bits_agree"] for r in ranks] == [(True, False)] * WORLD


@pytest.mark.parametrize("backend,device,staged", [
    ("gloo", "cuda", True), ("gloo", "cpu", False), ("nccl", "cuda", False)])
def test_p2p_through_host_follows_the_transport_and_device(backend, device, staged):
    """Point-to-point goes through host copies exactly for gloo ranks on a
    card (gloo aborts on sends of CUDA tensors), also for a mesh built by
    hand."""
    import torch

    from repro_torch.core.collectives import Mesh

    mesh = Mesh(shape=(2,), axis_names=("data",), rank=0, groups={"data": None},
                backend=backend, device=torch.device(device))
    assert mesh.p2p_through_host is staged


def test_meter_bytes_equal_the_interconnect_model(ranks):
    for r in ranks:
        assert r["recv_bytes"] == r["recv_model"] == (WORLD - 1) * 16 * 4
        # the ring is point-to-point sends and receives only: 2 (P - 1) hops
        assert r["ops"].count("send") == r["ops"].count("recv_") == 2 * (WORLD - 1)


@pytest.mark.parametrize("slots,world", [(228, 2), (228, 8), (16, 1), (0, 4)])
def test_interconnect_model_against_reference(slots, world):
    """``interconnect_bytes`` counts the reference's bytes; its time bound
    takes the transport's link rate (NVLink's 450 GB/s each way for NCCL,
    none for gloo through the host), never the reference's TPU link."""
    from repro.core import cost_model as ref_cost
    from repro_torch.core import cost_model

    ref = ref_cost.interconnect_bytes(slots, world)
    got = cost_model.interconnect_bytes(slots, world, transport="nccl")
    for key in ("recv_per_device", "send_per_device", "wire_total"):
        assert getattr(got, key) == getattr(ref, key), key
    assert got.vs_psum_recv() == ref.vs_psum_recv()
    assert got.time_s == got.recv_per_device / 450e9
    with pytest.raises(ValueError, match="gloo"):
        cost_model.interconnect_bytes(slots, world, transport="gloo").time_s
    with pytest.raises(ValueError):
        cost_model.interconnect_bytes(slots, 0)
