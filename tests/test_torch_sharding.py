"""The port's sharding rule table (``sharding/rules.py``), its parameter
axes (``lm.param_axes``) and optimizer state axes (``state_axes``)
against the JAX package's.

``spec_for`` is pure logic on the mesh's axis sizes, so, as the
reference's own tests do, the meshes are namespaces with a ``shape``
mapping: 16×16 ("data", "model"), 2×16×16 with "pod", and the factored
(16, 8, 2) with "model2".  The port's ``PartitionSpec`` is a tuple; it
is compared with JAX's ``P`` entry by entry.  The reference's parameter
shapes and axes come from one abstract trace of its ``lm.init`` at the
full config (``jax.eval_shape``, the axes captured as the trace builds
them), so nothing is allocated.  DTensor placements are checked on a
stand-in mesh (the names and shape a ``DeviceMesh`` reports): no process
group starts.
"""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402
from repro_torch.sharding import rules as R  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import tree as T  # noqa: E402

MESH = SimpleNamespace(shape={"data": 16, "model": 16})
MESH_MP = SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16})
MESH_F = SimpleNamespace(shape={"data": 16, "model": 8, "model2": 2})
MESHES = {"16x16": MESH, "2x16x16": MESH_MP, "16x8x2": MESH_F}
ARCHS = ("granite-3-2b", "dbrx-132b", "minicpm3-4b", "rwkv6-1.6b",
         "recurrentgemma-9b", "whisper-tiny")


def _entries(spec):
    return tuple(spec)


def _ref_tree(arch):
    """(shapes by key path, axes tree) of the reference's full ``lm.init``,
    traced abstractly."""
    from repro.configs.base import get_config as ref_config
    from repro.models import lm as ref_lm
    box = {}

    def init(key):
        params, axes = ref_lm.init(ref_config(arch), key)
        box["axes"] = axes
        return params

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    by_path = {tuple(k.key for k in path): tuple(leaf.shape)
               for path, leaf in flat}
    return by_path, box["axes"]


_REF = {}


def ref_tree(arch):
    if arch not in _REF:
        _REF[arch] = _ref_tree(arch)
    return _REF[arch]


# --- the cases of tests/test_distribution.py:28-64 -----------------------


def test_spec_basic_tp_fsdp():
    assert R.spec_for((18432, 96, 192), "embed heads head_dim", MESH) == \
        R.P("data", "model", None)
    # batch spans pod+data on the multi-pod mesh
    assert R.spec_for((256, 4096), "batch seq", MESH_MP) == \
        R.P(("pod", "data"), None)


def test_spec_indivisible_falls_back_replicated():
    # 49155 vocab is indivisible by 16 → replicated
    assert R.spec_for((49155, 2048), "vocab embed", MESH) == \
        R.P(None, ("data", "model"))


def test_spec_greedy_fill_soaks_unused_axes():
    assert R.spec_for((18432, 8, 192), "embed kv_heads head_dim",
                      MESH) == R.P(("data", "model"), None, None)
    assert R.spec_for((18432, 96, 192), "embed heads head_dim", MESH) == \
        R.P("data", "model", None)
    assert R.spec_for((18432, 8, 192), "embed_kv kv_heads head_dim",
                      MESH) == R.P("data", None, None)


def test_spec_no_axis_reuse():
    sp = R.spec_for((4096, 4096), "embed mlp", MESH)
    used = [a for part in sp for a in
            ((part,) if isinstance(part, str) else (part or ()))]
    assert len(used) == len(set(used))


def test_parse_axes():
    assert R.parse_axes("embed . heads") == ("embed", None, "heads")
    assert R.parse_axes("") == ()


def test_rule_table_is_the_reference_one():
    from repro.sharding import rules as ref
    assert R.DEFAULT_RULES == ref.DEFAULT_RULES
    assert R._GREEDY == ref._GREEDY


# --- every parameter leaf at full shapes ---------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_every_leaf_equals_reference(arch):
    from repro.sharding import rules as ref
    ref_shapes, ref_axes = ref_tree(arch)
    cfg = get_config(arch)
    shapes = convert.tree_shapes(cfg)
    axes = lm.param_axes(cfg)
    assert set(shapes) == set(ref_shapes)
    for name, mesh in MESHES.items():
        for path, shape in shapes.items():
            assert shape == ref_shapes[path], (path, shape)
            mine = R.spec_for(shape, T.get(axes, path), mesh)
            want = ref.spec_for(shape, T.get(ref_axes, path), mesh)
            assert _entries(mine) == _entries(want), (name, path)


def test_tree_spec_over_nested_dicts():
    cfg = get_config("granite-3-2b")
    shapes = {k: SimpleNamespace(shape=s)
              for k, s in convert.tree_shapes(cfg).items()}
    tree = {}
    for path, leaf in shapes.items():
        T.put(tree, path, leaf)
    specs = R.tree_spec(tree, lm.param_axes(cfg), MESH)
    assert T.get(specs, ("embed",)) == R.P(None, ("data", "model"))
    assert T.get(specs, ("blocks", "b0", "attn", "wq")) == \
        R.P(None, "data", "model", None)


# --- the axes trees ------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_equal_reference(arch):
    assert lm.param_axes(get_config(arch)) == ref_tree(arch)[1]


@pytest.mark.parametrize("arch", ("granite-3-2b", "minicpm3-4b",
                                  "rwkv6-1.6b", "whisper-tiny"))
@pytest.mark.parametrize("name", ("adamw", "adafactor"))
def test_state_axes_equal_reference(arch, name):
    from repro.train import optimizer as ref_opt
    axes = ref_tree(arch)[1]
    mine = topt.make_optimizer(name, lambda c: 1e-3).state_axes(axes)
    want = ref_opt.make_optimizer(name, lambda c: 1e-3).state_axes(axes)
    assert mine == want


# --- DTensor placements --------------------------------------------------


def _stand_in(sizes):
    """What ``placements_for``/``spec_of`` read of a ``DeviceMesh``."""
    return SimpleNamespace(mesh_dim_names=tuple(sizes),
                           mesh=torch.empty(tuple(sizes.values())))


@pytest.mark.parametrize("name", list(MESHES))
def test_placements_round_trip_to_specs(name):
    from torch.distributed.tensor import Replicate, Shard
    mesh = _stand_in(MESHES[name].shape)
    cfg = get_config("granite-3-2b")
    axes = lm.param_axes(cfg)
    for path, shape in convert.tree_shapes(cfg).items():
        spec = R.spec_for(shape, T.get(axes, path), mesh)
        pl = R.placements_for(spec, mesh)
        assert len(pl) == len(mesh.mesh_dim_names)
        assert all(isinstance(p, (Shard, Replicate)) for p in pl)
        assert R.spec_of(pl, mesh, len(shape)) == spec, path
    # a dim over two axes is Shard(d) on each, major first
    pl = R.placements_for(R.P(None, ("data", "model")), mesh)
    names = mesh.mesh_dim_names
    assert pl[names.index("data")] == Shard(1)
    assert pl[names.index("model")] == Shard(1)
    with pytest.raises(AssertionError):
        R.placements_for(R.P(("model", "data"), None), mesh)


def test_constrain_is_identity_without_a_mesh():
    x = torch.ones(4, 8)
    assert R.constrain(x, ("batch", None)) is x
    with R.use_mesh(None):
        assert R.constrain(x, ("batch", None)) is x


def test_local_shape_divides_every_split_dim():
    assert R.local_shape((49155, 2048), R.P(None, ("data", "model")),
                         MESH) == (49155, 8)
    assert R.local_shape((256, 4096), R.P(("pod", "data"), None),
                         MESH_MP) == (8, 4096)
