"""cddp_tpu.utils.struct: the frozen pytree dataclasses every problem,
model, constraint, objective and solution is built from. The tree
structure, the split into leaves and static fields, and so the jit cache
keys, are pinned per class."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cddp_tpu as ct
from cddp_tpu.constraints.barrier import DiscreteBarrierState, RelaxedLogBarrier
from cddp_tpu.models import LTISystem, Pendulum, Unicycle, quadrotor
from cddp_tpu.solution import IterationHistory, Solution
from cddp_tpu.utils import struct

ROOT = Path(__file__).resolve().parent.parent


def _objective():
    return ct.quadratic_objective(jnp.eye(3), jnp.eye(2), jnp.eye(3),
                                  jnp.zeros(3), 0.1)


def _problem():
    return ct.problem(Unicycle(), _objective(), jnp.zeros(3), 5, 0.1)


INSTANCES = {
    "Unicycle": Unicycle,
    "Pendulum": Pendulum,
    "Quadrotor": lambda: quadrotor(),
    "LTISystem": lambda: LTISystem(A=jnp.eye(2), B=jnp.ones((2, 1))),
    "QuadraticObjective": _objective,
    "ControlConstraint": lambda: ct.control_constraint(-jnp.ones(2),
                                                       jnp.ones(2)),
    "BallConstraint": lambda: ct.ball_constraint(0.4, jnp.ones(2)),
    "TerminalEquality": lambda: ct.terminal_equality_constraint(
        jnp.zeros(3)),
    "TerminalInequality": lambda: ct.terminal_inequality_constraint(
        jnp.eye(3)[:2], jnp.ones(2)),
    "RelaxedLogBarrier": lambda: RelaxedLogBarrier(
        barrier_coeff=jnp.asarray(1e-2), relaxation_delta=jnp.asarray(0.1)),
    "DiscreteBarrierState": lambda: DiscreteBarrierState(
        barrier=RelaxedLogBarrier(), decay_rate=jnp.asarray(0.9)),
    "IterationHistory": lambda: IterationHistory(objective=jnp.arange(3.0)),
    "Problem": _problem,
    "Solution": lambda: Solution(solver_name="CLDDP",
                                 final_objective=jnp.asarray(1.0)),
}


def _partition(obj):
    fields = dataclasses.fields(obj)
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    meta = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    return data, meta


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_roundtrip(name):
    obj = INSTANCES[name]()
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(back) is type(obj)
    assert jax.tree_util.tree_structure(back) == treedef
    for a, b in zip(jax.tree_util.tree_leaves(back), leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # tree_map keeps the class and its static fields
    doubled = jax.tree.map(lambda v: v * 2, obj)
    assert type(doubled) is type(obj)
    _, meta = _partition(obj)
    for m in meta:
        assert getattr(doubled, m) == getattr(obj, m)


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_replace_and_frozen(name):
    obj = INSTANCES[name]()
    field = dataclasses.fields(obj)[0].name
    new = obj.replace(**{field: "sentinel"})
    assert type(new) is type(obj)
    assert getattr(new, field) == "sentinel"
    assert getattr(obj, field) != "sentinel"
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(obj, field, None)


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_static_fields_are_structure_not_leaves(name):
    obj = INSTANCES[name]()
    data, meta = _partition(obj)
    n_leaves = len(jax.tree_util.tree_leaves(
        [getattr(obj, d) for d in data]))
    assert len(jax.tree_util.tree_leaves(obj)) == n_leaves
    for m in meta:
        value = getattr(obj, m)
        changed = obj.replace(**{m: ("other", value)})
        assert (jax.tree_util.tree_structure(changed)
                != jax.tree_util.tree_structure(obj))


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_jit_retraces_only_on_static_change(name):
    obj = INSTANCES[name]()
    traces = []

    @jax.jit
    def f(o):
        traces.append(1)
        return jax.tree.map(lambda v: v + 1, o)

    f(obj)
    f(jax.tree.map(lambda v: v * 3, obj))
    assert len(traces) == 1
    _, meta = _partition(obj)
    if meta:
        f(obj.replace(**{meta[0]: ("other", getattr(obj, meta[0]))}))
        assert len(traces) == 2


@pytest.mark.parametrize("cls,data,meta", [
    (ct.Problem, ["model", "objective", "x0", "timestep", "constraints",
                  "terminal_constraints"], ["horizon"]),
    (Unicycle, [], ["integration_type", "state_dim", "control_dim"]),
    (ct.ControlConstraint, ["lower", "upper", "scale_factor"],
     ["dual_dim"]),
    (Solution, ["status_code", "iterations_completed", "solve_time_ms",
                "final_objective", "final_step_length",
                "final_regularization", "time_points", "state_trajectory",
                "control_trajectory", "feedback_gains", "feedforward_gains",
                "dual_trajectories", "slack_trajectories",
                "costate_trajectory", "terminal_duals", "barrier_mu",
                "inf_pr", "inf_du", "inf_comp", "history"], ["solver_name"]),
])
def test_field_partition(cls, data, meta):
    """Leaves and static fields in declaration order, as every jit cache
    key and saved solver state has them."""
    fields = dataclasses.fields(cls)
    assert [f.name for f in fields
            if f.metadata.get("pytree_node", True)] == data
    assert [f.name for f in fields
            if not f.metadata.get("pytree_node", True)] == meta


def test_problem_treedef():
    assert str(jax.tree_util.tree_structure(_problem())) == (
        "PyTreeDef(CustomNode(Problem[(5,)], [CustomNode(Unicycle[('euler',"
        " 3, 2)], []), CustomNode(QuadraticObjective[()], [*, *, *, *, "
        "None]), *, *, {}, {}]))"
    )


def test_subclass_of_subclass_is_registered():
    class Base(struct.PyTreeNode):
        a: jax.Array = None

    class Child(Base):
        b: int = struct.field(pytree_node=False, default=3)

    c = Child(a=jnp.ones(2))
    leaves, treedef = jax.tree_util.tree_flatten(c)
    assert len(leaves) == 1 and c.replace(b=4).b == 4
    assert jax.tree_util.tree_unflatten(treedef, leaves).b == 3


def test_import_without_flax():
    """The package and its entry points import with flax unavailable."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'flax' or name.startswith('flax.'):\n"
        "            raise ImportError('flax blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import cddp_tpu, cddp_tpu.parallel.batch, cddp_tpu.solvers\n"
        "from cddp_tpu.ops.pallas import mega_clddp\n"
        "assert 'flax' not in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_chip_smoke_refuses_cpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a GPU."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)},
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr
