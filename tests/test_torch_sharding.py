"""The port's partition-spec rules and extents against the JAX package's.

For every leaf of the train state of GPT-2 ``test-tiny`` and ``gpt2-small``
and BERT ``bert-test-tiny`` under optax's ``adamw``, ``adam`` and ``sgd``
(shapes only, from ``jax.eval_shape``): the port's ``state_layout`` names
the JAX tree's leaves with their shapes and dtypes; and, of the AdamW state
of the GPT-2 presets, on a
``data`` mesh of n in {1, 2, 4, 8} host devices the port's ``fsdp_rules``,
``zero3_block_rules`` and ``replicated_rules`` give the spec the JAX
package's ``pspec_tree`` gives (printed as JAX prints it), and ``sharding.extent`` of
position r is what ``NamedSharding.devices_indices_map`` gives the mesh's
r-th device; on 2-D ``(data, model)`` meshes the same for
``tensor_parallel_rules`` composed with ``fsdp_rules``. The lint refuses
what the JAX package's lint refuses.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding

from saturn_tpu.models.gpt2 import build_gpt2 as j_build_gpt2
from saturn_tpu.ops import collective_matmul as jcm
from saturn_tpu.parallel import sharding as jshr
from saturn_tpu.utils.treepath import path_str
from saturn_tpu_torch.models import convert
from saturn_tpu_torch.models.gpt2 import build_gpt2
from saturn_tpu_torch.ops import collective_matmul as tcm
from saturn_tpu_torch.parallel import sharding as tshr


OPTIMIZERS = {"adamw": (optax.adamw, torch.optim.AdamW), "adam": (optax.adam, torch.optim.Adam),
              "sgd": (optax.sgd, torch.optim.SGD)}


def _jax_build(preset):
    if preset.startswith("bert"):
        from saturn_tpu.models.bert import build_bert

        return build_bert(preset)
    return j_build_gpt2(preset)


def _port_build(preset):
    if preset.startswith("bert"):
        from saturn_tpu_torch.models.bert import build_bert

        return build_bert(preset)
    return build_gpt2(preset)


def _jax_tree(preset, optimizer="adamw"):
    """The JAX package's train state of ``preset``, shapes only."""
    spec = _jax_build(preset)

    def init():
        params = spec.init_fn(jax.random.PRNGKey(0))
        return {"params": params, "opt_state": OPTIMIZERS[optimizer][0](1e-3).init(params),
                "step": jax.numpy.zeros((), jax.numpy.int32)}

    return jax.eval_shape(init)


def _jax_shapes(preset, optimizer="adamw"):
    shapes = _jax_tree(preset, optimizer)
    return {path_str(p): (tuple(leaf.shape), str(leaf.dtype))
            for p, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}


def _port_shapes(preset, optimizer="adamw"):
    model = _port_build(preset).abstract_init()
    opt = OPTIMIZERS[optimizer][1]([torch.zeros(1)], lr=1e-3)
    return {leaf.key: (tuple(leaf.shape), convert.leaf_dtype_name(leaf))
            for leaf in convert.state_layout(model, opt)}


_SHAPES = {}


def shapes(preset):
    """The JAX tree's ``{path: shape}`` of the AdamW state of ``preset``."""
    if preset not in _SHAPES:
        _SHAPES[preset] = {k: shape for k, (shape, _) in _jax_shapes(preset).items()}
    return _SHAPES[preset]


RULES = {
    "fsdp": (lambda: jshr.fsdp_rules(axis="data"), lambda: tshr.fsdp_rules(axis="data")),
    "zero3": (lambda: jcm.zero3_block_rules(axis="data"),
              lambda: tcm.zero3_block_rules(axis="data")),
    "replicated": (lambda: jshr.replicated_rules, lambda: tshr.replicated_rules),
}


@pytest.mark.parametrize("optimizer", list(OPTIMIZERS))
@pytest.mark.parametrize("preset", ["test-tiny", "gpt2-small", "bert-test-tiny"])
def test_the_layout_is_the_jax_tree(preset, optimizer):
    """Every leaf's path, shape and dtype, the optimizer's read off a JAX
    state of optax's ``adamw``, ``adam`` and ``sgd``."""
    assert _port_shapes(preset, optimizer) == _jax_shapes(preset, optimizer)


def _check_extents(jspec, tspec, shape, mesh, mesh_axes):
    jmap = NamedSharding(mesh, jspec).devices_indices_map(shape)
    for r, dev in enumerate(mesh.devices.flat):
        want = tuple((0 if sl.start is None else sl.start, d if sl.stop is None else sl.stop)
                     for sl, d in zip(jmap[dev], shape))
        assert tshr.extent(tspec, shape, mesh_axes, r) == want


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("preset", ["test-tiny", "gpt2-small"])
def test_rules_and_extents_equal_jax(preset, rule, n):
    jshapes = shapes(preset)
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    mesh_axes = {"data": n}
    jrule, trule = RULES[rule][0](), RULES[rule][1]()
    tspecs = tshr.pspec_tree(jshapes, trule, mesh_axes)
    jtree = jshr.pspec_tree(_jax_tree(preset), jrule, mesh)
    jspecs = {path_str(p): spec for p, spec in jax.tree_util.tree_flatten_with_path(
        jtree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    assert jspecs.keys() == jshapes.keys()
    for path, shape in jshapes.items():
        jspec = jspecs[path]
        assert tspecs[path] == tuple(jspec), path
        assert tshr.spec_str(tspecs[path]) == str(jspec)
        _check_extents(jspec, tspecs[path], shape, mesh, mesh_axes)


@pytest.mark.parametrize("sizes", [(2, 2), (2, 4), (4, 2)])
def test_fsdp_composed_with_tp_on_a_2d_mesh(sizes):
    jshapes = shapes("test-tiny")
    mesh = Mesh(np.array(jax.devices()[:sizes[0] * sizes[1]]).reshape(sizes), ("data", "model"))
    mesh_axes = {"data": sizes[0], "model": sizes[1]}
    jrule = jshr.compose_rules(jshr.tensor_parallel_rules("model"), jshr.fsdp_rules("data"))
    trule = tshr.compose_rules(tshr.tensor_parallel_rules("model"), tshr.fsdp_rules("data"))
    for path, shape in jshapes.items():
        jspec = jrule(path, shape, mesh_axes)
        assert trule(path, shape, mesh_axes) == tuple(jspec), path
        _check_extents(jspec, tuple(jspec), shape, mesh, mesh_axes)


def test_a_dimension_over_two_axes_splits_major_to_minor():
    from jax.sharding import PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    for spec in [P(("data", "model"), None), P(("model", "data"), None), P("model", "data")]:
        _check_extents(spec, tuple(spec), (8, 4), mesh, {"data": 2, "model": 2})


@pytest.mark.parametrize("spec,shape", [(("data", None, None), (4, 4)),
                                        (("nope",), (4,)),
                                        ((("data", "nope"), None), (4, 4))])
def test_the_lint_refuses_what_jax_refuses(spec, shape):
    from jax.sharding import PartitionSpec as P

    from saturn_tpu.analysis import jax_lint

    with pytest.raises(ValueError):
        jax_lint.enforce_pspec(P(*spec), shape, {"data": 2}, path="x")
    with pytest.raises(tshr.ShardingLintError):
        tshr.enforce_spec(spec, shape, {"data": 2}, path="x")
