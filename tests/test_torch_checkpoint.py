"""Checkpoints and the token readers of the port (``repro_torch.checkpoint``,
``repro_torch.data``), mirroring ``tests/test_checkpoint.py`` and
``tests/test_data.py`` and held against the reference where both write or
read the same bytes.

  * The manager: round trip, keep-N, an uncommitted checkpoint ignored,
    shape validation, a CRC32 per leaf in the manifest, a flipped bit and
    a truncated shard detected, quarantine, ``restore_latest_valid``; a
    save followed by an in-place update restores the saved values bitwise
    (the snapshot is taken before ``save`` returns); bf16 leaves round-trip
    bitwise (NaN payloads and -0.0 included); a leaf's key and CRC equal the
    reference manager's for the same values; ``AdamWState`` and device and
    dtype of the ``like`` tree; resume continuity of tiny olmo training;
    restored parameters receive the next step's gradients.
  * ``MemmapTokens``: batches equal the reference's bitwise for the same
    file, seed and shard, across ``seek`` and an epoch boundary.
    ``Prefetcher`` keeps the source's order.

Every comparison here is exact: the manager moves bits, and the readers
are the same numpy code.
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.data import MemmapTokens as RefMemmapTokens
from repro.data import ShardInfo as RefShardInfo
from repro_torch import optim
from repro_torch import reduce as R
from repro_torch.checkpoint import CheckpointCorruptionError, CheckpointManager
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.data import MemmapTokens, Prefetcher, ShardInfo, SyntheticLM
from repro_torch.launch import train as train_cli


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((16, 8), generator=g),
        "nested": {"b": torch.arange(5.0) + seed, "step": torch.tensor(3, dtype=torch.int32)},
    }


def _zeros_like(tree):
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    return {k: _zeros_like(v) for k, v in tree.items()}


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.is_floating_point:
        it = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.view(it), b.view(it))
    return torch.equal(a, b)


def test_save_restore_roundtrip(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    tree = _tree()
    cm.save(10, tree, extra={"data_step": 10}, blocking=True)
    assert cm.latest() == 10
    out = cm.restore(10, _zeros_like(tree))
    for a, b in zip(R.tree_leaves(out), R.tree_leaves(tree)):
        assert _bits_equal(a, b)
    assert cm.manifest(10)["extra"]["data_step"] == 10
    assert (tmp_path / "step_00000010" / "_COMMITTED").exists()
    assert sorted(p.name for p in (tmp_path / "step_00000010").iterdir()) == [
        "_COMMITTED", "manifest.json", "shard_00000.npz"]


def test_keep_n_garbage_collection(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _tree(s), blocking=True)
    steps = sorted(int(p.name.split("_")[1]) for p in pathlib.Path(tmp_path).glob("step_*"))
    assert steps == [3, 4]


def test_uncommitted_checkpoint_ignored(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(5, _tree(), blocking=True)
    broken = pathlib.Path(tmp_path) / "step_00000009"  # a writer preempted mid-flush
    broken.mkdir()
    (broken / "shard_00000.npz").write_bytes(b"garbage")
    assert cm.latest() == 5
    with pytest.raises(FileNotFoundError):
        cm.restore(9, _tree())


def test_restore_validates_shapes(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(1, {"w": torch.zeros((4, 4))}, blocking=True)
    with pytest.raises(ValueError):
        cm.restore(1, {"w": torch.zeros((5, 4))})


def _rewrite_leaf(ckpt_dir, step, key, mutate):
    """Rewrite one leaf inside the committed shard WITHOUT updating the
    manifest: a readable archive whose bytes no longer match the CRCs."""
    shard = pathlib.Path(ckpt_dir) / f"step_{step:08d}" / "shard_00000.npz"
    with np.load(shard) as z:
        data = {k: z[k] for k in z.files}
    data[key] = mutate(data[key])
    np.savez(shard, **data)


def test_manifest_records_per_leaf_crc(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(1, _tree(), blocking=True)
    leaves = cm.manifest(1)["leaves"]
    assert sorted(leaves) == ["['nested']['b']", "['nested']['step']", "['w']"]
    assert all("crc32" in v for v in leaves.values())
    assert leaves["['w']"] == {"shape": [16, 8], "dtype": "float32",
                               "crc32": leaves["['w']"]["crc32"]}


def test_bit_flip_detected_on_restore(tmp_path):
    cm = CheckpointManager(tmp_path)
    tree = _tree()
    cm.save(1, tree, blocking=True)
    key = "['w']"

    def flip(a):
        buf = bytearray(np.ascontiguousarray(a).tobytes())
        buf[0] ^= 1  # one flipped bit, the minimal corruption
        return np.frombuffer(bytes(buf), dtype=a.dtype).reshape(a.shape)

    _rewrite_leaf(tmp_path, 1, key, flip)
    with pytest.raises(CheckpointCorruptionError, match="CRC mismatch"):
        cm.restore(1, _zeros_like(tree))
    cm.restore(1, _zeros_like(tree), verify=False)  # the forensic escape hatch


def test_truncated_shard_detected(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(3, _tree(), blocking=True)
    shard = pathlib.Path(tmp_path) / "step_00000003" / "shard_00000.npz"
    shard.write_bytes(shard.read_bytes()[: shard.stat().st_size // 2])
    with pytest.raises(CheckpointCorruptionError, match="unreadable shard"):
        cm.restore(3, _tree())


def test_quarantine_hides_step_from_latest(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(1, _tree(1), blocking=True)
    cm.save(2, _tree(2), blocking=True)
    assert cm.latest() == 2
    dst = cm.quarantine(2)
    assert dst.exists() and cm.latest() == 1
    assert 2 not in cm._committed_steps()


def test_restore_latest_valid_falls_back_past_corruption(tmp_path):
    cm = CheckpointManager(tmp_path)
    t1, t2 = _tree(1), _tree(2)
    cm.save(1, t1, blocking=True)
    cm.save(2, t2, blocking=True)
    _rewrite_leaf(tmp_path, 2, "['w']", lambda a: a + 1)
    out, step = cm.restore_latest_valid(_zeros_like(t1))
    assert step == 1
    for a, b in zip(R.tree_leaves(out), R.tree_leaves(t1)):
        assert _bits_equal(a, b)
    assert (pathlib.Path(tmp_path) / "quarantine_step_00000002").exists()
    _rewrite_leaf(tmp_path, 1, "['w']", lambda a: a + 1)
    with pytest.raises(FileNotFoundError):  # everything corrupt: an explicit failure
        cm.restore_latest_valid(_zeros_like(t1))


def test_save_snapshots_before_returning(tmp_path):
    """``save`` copies the leaves before it returns: an in-place update
    right after it (what the training loop does next) does not reach the
    checkpoint, whose CRCs and values are the saved step's."""
    cm = CheckpointManager(tmp_path)
    tree = _tree()
    want = {k: v.clone() for k, v in [("w", tree["w"]), ("b", tree["nested"]["b"])]}
    cm.save(1, tree)
    tree["w"].add_(1.0)          # in place, while the flush may still be running
    tree["nested"]["b"].mul_(-2.0)
    cm.wait()
    out = cm.restore(1, _zeros_like(tree))
    assert _bits_equal(out["w"], want["w"]) and _bits_equal(out["nested"]["b"], want["b"])


def test_save_then_train_step_restores_saved_state(tmp_path):
    """The same through a tiny olmo train step, which updates parameters
    and moments in place."""
    cfg = get_arch("olmo-1b", tiny=True)
    params, opt, step = train_cli.build(cfg, TrainConfig(total_steps=4, warmup_steps=1), "cpu")
    data = SyntheticLM(cfg.vocab_size, 8, 2, seed=0)
    params, opt, _ = step(params, opt, {"tokens": torch.from_numpy(data.next()["tokens"])})
    want = [t.detach().clone() for t in R.tree_leaves((params, opt.m, opt.v))]
    cm = CheckpointManager(tmp_path)
    cm.save(1, (params, opt))
    params, opt, _ = step(params, opt, {"tokens": torch.from_numpy(data.next()["tokens"])})
    cm.wait()
    rparams, ropt = cm.restore(1, (params, opt))
    assert int(ropt.step) == 1 and int(opt.step) == 2
    got = R.tree_leaves((rparams, ropt.m, ropt.v))
    assert all(_bits_equal(g, w) for g, w in zip(got, want))
    assert not all(_bits_equal(a.detach(), w) for a, w in zip(R.tree_leaves(params), want))


def test_bf16_round_trip_bitwise(tmp_path):
    x = torch.randn(64).to(torch.bfloat16)
    bits = x.view(torch.int16)
    bits[0] = 0x7FC1    # a NaN with a payload
    bits[1] = -0x8000   # -0.0
    bits[2] = 0x7F80    # +Inf
    cm = CheckpointManager(tmp_path)
    cm.save(1, {"x": x}, blocking=True)
    assert cm.manifest(1)["leaves"]["['x']"]["dtype"] == "bfloat16"
    out = cm.restore(1, {"x": torch.zeros(64, dtype=torch.bfloat16)})
    assert out["x"].dtype == torch.bfloat16 and _bits_equal(out["x"], x)
    # a bf16 leaf restores into an f32 like leaf by value
    out = cm.restore(1, {"x": torch.zeros(64)})
    assert torch.equal(out["x"][3:], x[3:].float())


def test_leaf_keys_and_crcs_equal_the_reference(tmp_path):
    """The same values saved by both managers: the same leaf keys, shapes,
    dtype names and CRC32s (bf16 hashed over the same 16-bit patterns)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((6, 10)).astype(np.float32)
    b = (rng.standard_normal(7) * 3).astype(np.float32)
    port = {"w": torch.from_numpy(w), "nested": {"b": torch.from_numpy(b).to(torch.bfloat16),
                                                 "step": torch.tensor(7, dtype=torch.int32)}}
    ref = {"w": jnp.asarray(w), "nested": {"b": jnp.asarray(b).astype(jnp.bfloat16),
                                           "step": jnp.asarray(7, jnp.int32)}}
    CheckpointManager(tmp_path / "port").save(1, port, blocking=True)
    RefCheckpointManager(tmp_path / "ref").save(1, ref, blocking=True)
    mp = json.loads((tmp_path / "port" / "step_00000001" / "manifest.json").read_text())
    mr = json.loads((tmp_path / "ref" / "step_00000001" / "manifest.json").read_text())
    assert mp["leaves"] == mr["leaves"]


def test_adamw_state_restores_on_like_device_and_dtype(tmp_path):
    params = {"a": torch.randn(3, 4).to(torch.bfloat16), "b": torch.randn(5)}
    opt = optim.init_state(params)
    opt.m[0].normal_()
    opt.step.fill_(4)
    cm = CheckpointManager(tmp_path)
    cm.save(4, (params, opt), blocking=True)
    assert "[1].m[0]" in cm.manifest(4)["leaves"] and "[1].step" in cm.manifest(4)["leaves"]
    like = ({"a": torch.zeros(3, 4, dtype=torch.bfloat16), "b": torch.zeros(5)},
            optim.init_state(params))
    rp, ro = cm.restore(4, like)
    assert isinstance(ro, optim.AdamWState) and int(ro.step) == 4
    assert ro.step.dtype == torch.int32 and rp["a"].dtype == torch.bfloat16
    assert _bits_equal(rp["a"], params["a"]) and _bits_equal(ro.m[0], opt.m[0])


def test_resume_continuity_exact(tmp_path):
    """Train 2 + 2 steps with a save and restore between == 4 straight
    (bitwise losses), on tiny olmo."""
    cfg = get_arch("olmo-1b", tiny=True)
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=8, warmup_steps=1)
    toks = torch.from_numpy(SyntheticLM(cfg.vocab_size, 8, 2, seed=7).next()["tokens"])

    def run(n, params, opt, step):
        losses = []
        for _ in range(n):
            params, opt, m = step(params, opt, {"tokens": toks})
            losses.append(float(m["loss"]))
        return params, opt, losses

    _, _, straight = run(4, *train_cli.build(cfg, tcfg, "cpu"))
    p1, o1, step = train_cli.build(cfg, tcfg, "cpu")
    p1, o1, first = run(2, p1, o1, step)
    cm = CheckpointManager(tmp_path)
    cm.save(2, (p1, o1), blocking=True)
    p2, o2 = cm.restore(2, (p1, o1))
    for p in R.tree_leaves(p2):
        p.requires_grad_(True)
    _, _, second = run(2, p2, o2, step)
    assert first + second == straight


def test_restored_parameters_receive_gradients(tmp_path):
    """The training loop's restore (``train._restore``) rebinds the live
    state to the restored tensors: they require grad, the next step's
    gradients reach them, and that step updates them."""
    cfg = get_arch("olmo-1b", tiny=True)
    params, opt, step = train_cli.build(cfg, TrainConfig(total_steps=4, warmup_steps=1), "cpu")
    cm = CheckpointManager(tmp_path)
    cm.save(0, (params, opt), extra={"data_step": 0}, blocking=True)
    rparams, ropt, data_step = train_cli._restore(cm, 0, params, opt)
    assert data_step == 0
    leaves = R.tree_leaves(rparams)
    assert all(p.requires_grad and p.is_leaf for p in leaves)
    assert not any(a is b for a, b in zip(leaves, R.tree_leaves(params)))
    before = [p.detach().clone() for p in leaves]
    toks = torch.from_numpy(SyntheticLM(cfg.vocab_size, 8, 2, seed=1).next()["tokens"])
    rparams, ropt, m = step(rparams, ropt, {"tokens": toks})
    assert int(ropt.step) == 1 and float(m["grad_norm"]) > 0
    assert all(not torch.equal(a.detach(), b) for a, b in zip(leaves, before))


# ------------------------------ token readers --------------------------------


@pytest.fixture
def token_file(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 50_000, size=33 * 37, dtype=np.uint32).tofile(path)
    return str(path)


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_memmap_tokens_match_reference(token_file, shard):
    """The same batches bit for bit through an epoch boundary and after a
    ``seek``; ``state`` and ``load_state`` as the reference's."""
    port = MemmapTokens(token_file, 32, 3, ShardInfo(*shard), seed=5)
    ref = RefMemmapTokens(token_file, 32, 3, RefShardInfo(*shard), seed=5)
    assert port.n_windows == ref.n_windows == 37
    steps_per_epoch = port.n_windows // (3 * shard[1])
    for _ in range(steps_per_epoch + 2):  # into the second epoch
        a, b = port.next()["tokens"], ref.next()["tokens"]
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    for target in (1, steps_per_epoch * 3 + 1):
        port.seek(target)
        ref.seek(target)
        np.testing.assert_array_equal(port.next()["tokens"], ref.next()["tokens"])
    assert port.state() == ref.state()
    other = MemmapTokens(token_file, 32, 3, ShardInfo(*shard), seed=5)
    other.load_state(port.state())
    np.testing.assert_array_equal(other.next()["tokens"], ref.next()["tokens"])


def test_memmap_tokens_refuse_a_file_under_one_batch(token_file):
    with pytest.raises(ValueError, match="smaller than one global batch"):
        MemmapTokens(token_file, 32, 20, ShardInfo(0, 2))


def test_prefetcher_keeps_the_order(token_file):
    src = MemmapTokens(token_file, 32, 2, seed=3)
    want = MemmapTokens(token_file, 32, 2, seed=3)
    pf = Prefetcher(src)
    try:
        for _ in range(25):  # past the first epoch
            np.testing.assert_array_equal(pf.next()["tokens"], want.next()["tokens"])
    finally:
        pf.close()
    pf.t.join(timeout=5)
    assert not pf.t.is_alive()


def test_failed_flush_raises_at_wait(tmp_path, monkeypatch):
    """A save whose background write fails (a full disk, a lost mount)
    raises at the next ``wait``, in the caller's thread, and commits
    nothing."""
    cm = CheckpointManager(tmp_path)

    def refuse(*args, **kwargs):
        raise OSError("no space left on device")

    monkeypatch.setattr(np, "savez", refuse)
    cm.save(1, _tree())
    with pytest.raises(OSError, match="no space"):
        cm.wait()
    assert cm.latest() is None
    cm.wait()  # the error is reported once
