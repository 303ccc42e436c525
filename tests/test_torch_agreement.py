"""The port's agreement checker (``repro_torch.runtime.agreement``) against
the reference's ``repro.runtime.agreement``, and across CPU ranks.

  * ``fingerprint`` and ``step_fingerprint`` give the reference's digests
    for the same Python and numpy values (the same hash over the same
    bytes), and a torch tensor hashes as the numpy array of its shape,
    dtype and bits (bf16 by its bits, on any device).
  * The reference's checker, transport and exchange cases, ported: a
    unanimous roster passes; a one-ulp drift raises ``DivergenceError``
    naming the lowest disagreeing host and the step; a silent host is not
    a divergence; a dead host times out; real processes agree, or all see
    the divergence.
  * On two gloo ranks: each rank's ``step_fingerprint`` of a
    ``reduce_tree(census=True, mesh_axes=)`` over its shards, exchanged
    over a ``FileTransport``, agrees; the planted fault (rank 1's statistic
    one ulp off) raises on both ranks, naming host 1.
"""

import multiprocessing as mp

import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from repro.runtime import agreement as ref_agreement
from repro_torch.runtime import (
    AgreementChecker,
    DivergenceError,
    FileTransport,
    Transport,
    exchange,
    fingerprint,
    step_fingerprint,
)

VALUES = [
    (np.arange(6, dtype=np.float32), 3, "tag"),
    ({"b": 1, "a": [2.5, None, True]}, b"raw"),
    (np.array([1.0, np.nan], np.float32), np.float64(7.25)),
]


@pytest.mark.parametrize("parts", VALUES, ids=["array-int-str", "nested", "nan-scalar"])
def test_fingerprint_is_the_reference_digest(parts):
    assert fingerprint(*parts) == ref_agreement.fingerprint(*parts)


def test_step_fingerprint_is_the_reference_digest_and_tensors_hash_as_arrays():
    x = np.array([1.0, np.nan], np.float32)
    assert step_fingerprint(3, x, 1.0, 2.5) == ref_agreement.step_fingerprint(3, x, 1.0, 2.5)
    assert step_fingerprint(3, torch.from_numpy(x), 1.0, 2.5) == step_fingerprint(3, x, 1.0, 2.5)
    a = np.arange(6, dtype=np.float32)
    assert fingerprint(torch.from_numpy(a)) == fingerprint(a)
    assert fingerprint(torch.from_numpy(a)) != fingerprint(torch.from_numpy(a).reshape(2, 3))
    # bf16 hashes by its bits: one ulp apart differ, equal bits agree
    h = torch.tensor([1.0, 2.0], dtype=torch.bfloat16)
    assert fingerprint(h) == fingerprint(h.clone())
    assert fingerprint(h) != fingerprint(torch.nextafter(h, torch.full_like(h, 3.0)))
    assert fingerprint(h) != fingerprint(h.to(torch.float16))


def test_fingerprint_bit_sensitive():
    a = np.arange(6, dtype=np.float32)
    b = a.copy()
    b[0] = np.nextafter(b[0], 1.0)
    assert fingerprint(a) != fingerprint(b)
    assert fingerprint({"b": 1, "a": 2}) == fingerprint({"a": 2, "b": 1})
    assert fingerprint((1, 2)) != fingerprint((2, 1))


def test_agreement_unanimous_and_divergent():
    chk = AgreementChecker(4)
    for step in (1, 2):
        fp = step_fingerprint(step, [0.0], 0.0, 7.25)
        for h in range(4):
            chk.record(step, h, fp)
        assert chk.check(step)
    assert chk.checks_passed == 2
    chk = AgreementChecker(4)
    good = step_fingerprint(5, [0.0], 0.0, 7.25)
    bad = step_fingerprint(5, [0.0], 0.0, np.nextafter(7.25, 8))
    chk.record(5, 3, bad)
    chk.record(5, 2, bad)
    with pytest.raises(DivergenceError) as ei:
        chk.record(5, 0, good)  # the reference lands: the LOWEST bad id is named
    assert ei.value.step == 5 and ei.value.host == 2 and ei.value.expected != ei.value.got


def test_agreement_missing_host_and_bad_geometry():
    chk = AgreementChecker(3)
    chk.record(1, 0, "x")
    chk.record(1, 1, "x")
    with pytest.raises(RuntimeError, match="host\\(s\\) \\[2\\]"):
        chk.check(1)
    assert chk.checks_passed == 0
    with pytest.raises(ValueError):
        AgreementChecker(0)
    with pytest.raises(ValueError):
        AgreementChecker(2).record(0, 2, "x")


def test_file_transport_and_exchange(tmp_path):
    tr = FileTransport(tmp_path / "fp")
    assert isinstance(tr, Transport)
    assert tr.fetch(3) == {}
    tr.publish(3, 0, "aaa")
    tr.publish(3, 2, "ccc")
    tr.publish(4, 0, "zzz")
    assert tr.fetch(3) == {0: "aaa", 2: "ccc"}
    (tmp_path / "fp" / "step000000000003.hostX").write_text("junk")
    assert set(tr.fetch(3)) == {0, 2}
    tr = FileTransport(tmp_path / "a")
    tr.publish(7, 1, "deadbeef")
    with pytest.raises(DivergenceError) as e:
        exchange(AgreementChecker(2), tr, 7, 0, "cafe", timeout_s=1.0)
    assert e.value.host == 1 and e.value.step == 7
    t = [0.0]

    def clock():
        return t[0]

    def sleep(dt):
        t[0] += dt

    with pytest.raises(TimeoutError, match=r"host\(s\) \[1\]"):
        exchange(AgreementChecker(2), FileTransport(tmp_path / "b"), 1, 0, "cafe",
                 timeout_s=0.5, clock=clock, sleep=sleep)


def _exchange_child(root, n_hosts, step, host, fp):
    import sys

    from repro_torch.runtime import AgreementChecker as AC
    from repro_torch.runtime import DivergenceError as DE
    from repro_torch.runtime import FileTransport as FT
    from repro_torch.runtime import exchange as ex

    try:
        ex(AC(n_hosts), FT(root), step, host, fp, timeout_s=60.0)
        sys.exit(0)
    except DE:
        sys.exit(7)
    except TimeoutError:
        sys.exit(9)


@pytest.mark.parametrize("diverge", [False, True], ids=["agree", "one-host-skipped"])
def test_exchange_across_real_processes(tmp_path, diverge):
    ctx = mp.get_context("spawn")
    good = step_fingerprint(12, [3.0], 0.0, 1.5)
    bad = step_fingerprint(12, [3.0], 1.0, 1.5) if diverge else good
    procs = [ctx.Process(target=_exchange_child,
                         args=(str(tmp_path), 2, 12, h, good if h == 0 else bad))
             for h in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert [p.exitcode for p in procs] == ([7, 7] if diverge else [0, 0])


def test_mesh_fingerprints_agree_and_the_planted_ulp_is_caught(tmp_path):
    rng = np.random.RandomState(1)
    leaves = [rng.randn(4, 8).astype(np.float32), rng.randn(6, 3).astype(np.float32)]
    leaves[1][5, 2] = np.nan  # rank 1's shard: the census counts it on both ranks
    res = W.run("agreement", 2, tmp_path / "ranks", str(tmp_path / "fp"), leaves)
    assert [r[1] for r in res] == [True, True]
    assert [r[2] for r in res] == [("divergence", 2, 1)] * 2
