"""The port's sharding rules against the reference's, on shape-only meshes.

``repro_torch.launch.sharding`` (rules dicts, ``spec_for``,
``batch_partition``, ``param_shardings``, ``cache_shardings``,
``batch_spec``) and ``launch.specs.microbatches_for`` held to
``repro.launch.sharding`` / ``repro.launch.specs`` on the meshes (2, 2),
(2, 4), (16, 16) and (2, 16, 16): the reference gets a shape-only stand-in
(its own tests' ``FakeMesh``), the port ``launch.mesh.abstract_mesh``; the
reference's ``NamedSharding`` is replaced by its spec (it needs devices).
A port spec is a tuple equal to ``tuple(PartitionSpec)`` entry for entry;
the reference's stacked unit leaves carry a leading None (the layer axis)
that the port's per-layer leaves lack.

``models.model.param_axes`` against the reference's ``init_params`` axes,
leaf for leaf through the port's tree paths, for the ten archs, tiny and
at full size (the reference on ``jax.eval_shape``, the port on the meta
device: nothing is allocated)."""

import itertools

import jax
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_arch
from repro.launch import sharding as RSH
from repro.launch import specs as RSPECS
from repro.models import init_params as ref_init
from repro.models import make_caches as ref_caches
from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import abstract_mesh, abstract_production_mesh
from repro_torch.launch.specs import microbatches_for
from repro_torch.models import make_caches
from repro_torch.models.convert import _leaf_paths
from repro_torch.models.model import init_params, param_axes

MESHES = {
    "2x2": ((2, 2), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
RULES = ("DEFAULT_RULES", "TP_ONLY_RULES", "BIG_MODEL_RULES", "SMALL_MODEL_RULES")


class FakeMesh:
    """The reference tests' shape-only mesh."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def meshes(name):
    shape, names = MESHES[name]
    return FakeMesh(dict(zip(names, shape))), abstract_mesh(shape, names)


@pytest.fixture
def specs_only(monkeypatch):
    """The reference's sharding functions returning their specs (a
    NamedSharding needs a real device mesh)."""
    monkeypatch.setattr(RSH, "NamedSharding", lambda mesh, spec: spec)


def _ref_axes(cfg):
    cell = {}

    def only(key):
        p, a = ref_init(key, cfg)
        cell["axes"] = a
        return p

    shapes = jax.eval_shape(only, jax.random.PRNGKey(0))
    return shapes, cell["axes"]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _ref_path(cfg, path):
    """The reference's tree path of a port leaf, and whether it is stacked."""
    if path[0] != "layers":
        return path, False
    pat = len(cfg.block_pattern)
    n_units = cfg.n_layers // pat
    layer = path[1]
    if layer < n_units * pat:
        return ("units", f"pos{layer % pat}") + tuple(path[2:]), True
    return ("tail", f"pos{layer - n_units * pat}") + tuple(path[2:]), False


def _unstack(spec, stacked):
    return tuple(spec)[1:] if stacked else tuple(spec)


def test_rule_dicts_equal_the_reference():
    for name in RULES:
        assert getattr(SH, name) == getattr(RSH, name), name


AXES_CASES = [None, ("embed", "ffn"), ("ffn", "embed"), ("vocab", None), ("vocab", "embed"),
              (None, "vocab"), ("embed", "heads"), ("embed", "kv_heads"), ("heads", "embed"),
              ("experts", "embed", "ffn"), ("experts", "ffn", "embed"), ("ffn", "heads"),
              ("embed", None), (None, "inner"), ("inner", None, None), ("embed",),
              (None, "vocab", "embed"), (None, None, "vocab")]
SHAPE_CASES = [None, (50280, 1536), (50432, 1536), (4096, 11008), (2, 64), (6, 64),
               (64, 4096), (16, 4096, 512)]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("rules", RULES)
def test_spec_for_equals_the_reference(mesh_name, rules):
    ref_mesh, mesh = meshes(mesh_name)
    for axes, shape in itertools.product(AXES_CASES, SHAPE_CASES):
        if shape is not None and (axes is None or len(shape) != len(axes)):
            continue
        want = RSH.spec_for(axes, getattr(RSH, rules), ref_mesh, shape)
        got = SH.spec_for(axes, getattr(SH, rules), mesh, shape)
        assert got == tuple(want), (axes, shape)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_partition_and_batch_spec(mesh_name):
    ref_mesh, mesh = meshes(mesh_name)
    for gb in (1, 2, 4, 8, 32, 128, 256, 512):
        assert SH.batch_partition(mesh, gb) == RSH.batch_partition(ref_mesh, gb)
    for extra in ((), (None,), (None, "model")):
        assert SH.batch_spec(mesh, extra) == tuple(RSH.batch_spec(ref_mesh, extra))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_microbatches_for_equals_the_reference(mesh_name):
    shape, _ = MESHES[mesh_name]
    data = shape[0] * (shape[1] if len(shape) == 3 else 1)
    for arch, shape_name in itertools.product(sorted(REF_ARCHS), sorted(REF_SHAPES)):
        for degree in (1, data):
            want = RSPECS.microbatches_for(ref_arch(arch), REF_SHAPES[shape_name], degree)
            assert microbatches_for(get_arch(arch), SHAPES[shape_name], degree) == want


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full"])
@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_param_axes_equal_the_reference(arch, tiny):
    cfg = get_arch(arch, tiny=tiny)
    rcfg = ref_arch(arch, tiny=tiny)
    _, ref_axes = _ref_axes(rcfg)
    axes = param_axes(cfg)
    meta = init_params(cfg, torch.Generator().manual_seed(0), torch.device("meta"))
    paths = _leaf_paths(meta)
    assert len(paths) == len(SH.tree_leaves(axes))
    for path in paths:
        rpath, stacked = _ref_path(cfg, path)
        want = _get(ref_axes, rpath)
        if stacked:
            want = want[1:] if want else None
        assert _get(axes, path) == want, path


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_param_shardings_equal_the_reference(specs_only, arch, mesh_name):
    ref_mesh, mesh = meshes(mesh_name)
    cfg, rcfg = get_arch(arch), ref_arch(arch)
    ref_shapes, ref_axes = _ref_axes(rcfg)
    meta = init_params(cfg, torch.Generator().manual_seed(0), torch.device("meta"))
    for rules in RULES:
        want = RSH.param_shardings(ref_axes, ref_mesh, getattr(RSH, rules), ref_shapes)
        got = SH.param_shardings(param_axes(cfg), mesh, getattr(SH, rules), meta)
        for path in _leaf_paths(meta):
            rpath, stacked = _ref_path(cfg, path)
            spec = _get(want, rpath)
            assert _get(got, path) == _unstack(spec, stacked), (rules, path)
        # without shapes: no divisibility guard
        want = RSH.param_shardings(ref_axes, ref_mesh, getattr(RSH, rules))
        got = SH.param_shardings(param_axes(cfg), mesh, getattr(SH, rules))
        for path in _leaf_paths(meta):
            rpath, stacked = _ref_path(cfg, path)
            assert _get(got, path) == _unstack(_get(want, rpath), stacked), (rules, path)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_cache_shardings_equal_the_reference(specs_only, arch, mesh_name):
    ref_mesh, mesh = meshes(mesh_name)
    cfg, rcfg = get_arch(arch, tiny=True), ref_arch(arch, tiny=True)
    for batch, s_max in ((32, 64), (3, 48)):
        ref_shapes = jax.eval_shape(lambda: ref_caches(rcfg, batch, s_max))
        want = RSH.cache_shardings(ref_shapes, rcfg, ref_mesh)
        caches = make_caches(cfg, batch, s_max, torch.device("meta"))
        got = SH.cache_shardings(caches, cfg, mesh)
        for path in _leaf_paths(caches):
            rpath, stacked = _ref_path(cfg, path)
            assert _get(got, path) == _unstack(_get(want, rpath), stacked), path


def test_blocks_cut_and_gather_back():
    """``block_of`` over every rank of a (2, 4) mesh tiles the tensor, and
    ``like_tree`` mirrors a spec tree over a value tree."""
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    spec = ("data", "model")
    seen = torch.zeros_like(x)
    for rank in range(8):
        mesh = abstract_mesh((2, 4), ("data", "model"))
        mesh = type(mesh)(shape=mesh.shape, axis_names=mesh.axis_names, rank=rank,
                          groups={}, backend="none", device=mesh.device)
        b = SH.block_of(x, spec, mesh)
        assert b.shape == SH.local_shape(x.shape, spec, mesh) == (4, 3)
        d, m = rank // 4, rank % 4
        assert torch.equal(b, x[d * 4:(d + 1) * 4, m * 3:(m + 1) * 3])
        seen[d * 4:(d + 1) * 4, m * 3:(m + 1) * 3] += 1
    assert torch.equal(seen, torch.ones_like(x))
    with pytest.raises(ValueError, match="does not split"):
        SH.local_shape((6, 12), ("data", ("model",)), abstract_mesh((4, 4), ("data", "model")))
    tree = {"a": [torch.zeros(2), torch.zeros(3)], "b": torch.zeros(1)}
    specs = {"a": [("data",), ()], "b": ("model",)}
    assert SH.like_tree(tree, specs) == specs


def test_production_mesh_shapes():
    from repro_torch.launch.mesh import make_production_mesh

    assert abstract_production_mesh().shape == (16, 16)
    assert abstract_production_mesh(multi_pod=True).axis_names == ("pod", "data", "model")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh()


def test_activation_context():
    """``models.context``: a no-op without a context; with one, activations
    and the MoE dispatch block are checked to hold the rank's rows (and
    experts), ``batch_axis_entry`` and the degrees read the mesh, and
    ``shard_map_specs`` returns the function itself."""
    from repro_torch.models import context as CTX

    h = torch.zeros(4, 8, 16)
    assert CTX.constrain(h) is h and CTX.batch_axis_entry() is None
    assert CTX.shard_map_specs(len, (), ()) is None
    assert CTX.data_degree() == CTX.model_degree() == 1
    mesh = abstract_mesh((2, 4), ("data", "model"))
    with CTX.activation_sharding(mesh, ("data", None, None), rows=4):
        assert CTX.constrain(h) is h
        assert CTX.batch_axis_entry() == "data"
        assert (CTX.data_degree(), CTX.model_degree()) == (2, 4)
        assert CTX.shard_map_specs(len, (), ()) is len
        with pytest.raises(ValueError, match="rank's share is 4"):
            CTX.constrain(torch.zeros(8, 8, 16))
        assert CTX.constrain_moe_dispatch(torch.zeros(4, 2, 3, 16), n_experts=8).shape[1] == 2
        with pytest.raises(ValueError, match="a rank holds 2"):
            CTX.constrain_moe_dispatch(torch.zeros(4, 8, 3, 16), n_experts=8)
    assert CTX.get_activation_sharding() is None
