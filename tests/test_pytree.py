"""The in-repo pytree dataclass (core/pytree.py) behind FilterState and
TrackState: `.replace`, a static `layout` under jit and vmap, leaf counts."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from plviwo_tpu.core.frame import TrackState, make_track_state
from plviwo_tpu.core.layout import StateLayout
from plviwo_tpu.core.state import FilterState, make_state


def _layout(n_clones=4):
    return StateLayout(n_clones=n_clones, n_cams=1)


def test_replace_returns_a_copy():
    st = make_state(_layout())
    st2 = st.replace(p=jnp.ones(3))
    assert isinstance(st2, FilterState)
    assert float(st2.p.sum()) == 3.0 and float(st.p.sum()) == 0.0
    assert st2.cov is st.cov and st2.layout is st.layout
    with pytest.raises(dataclasses.FrozenInstanceError):
        st.p = jnp.ones(3)


def test_layout_is_static_under_jit_and_vmap():
    traces = []

    @jax.jit
    def step(st):
        traces.append(st.layout)  # a Python value while tracing
        return st.replace(cov=st.cov * 2.0 + st.layout.dim)

    st = make_state(_layout(4))
    out = step(st)
    assert out.layout == st.layout
    step(st.replace(p=jnp.ones(3)))  # same layout: no retrace
    assert len(traces) == 1
    step(make_state(_layout(5)))  # another layout: a new trace
    assert len(traces) == 2

    batched = jax.tree.map(lambda x: jnp.stack([x, x]), st)
    out_b = jax.vmap(step)(batched)
    assert out_b.layout == st.layout
    assert out_b.cov.shape == (2,) + st.cov.shape


def test_leaf_counts():
    """Every array field is a leaf; the layout lives in the treedef."""
    st = make_state(_layout())
    n_fields = len(dataclasses.fields(FilterState))
    leaves, treedef = jax.tree_util.tree_flatten(st)
    assert len(leaves) == n_fields - 1  # all but `layout`
    assert all(isinstance(x, jax.Array) for x in leaves)
    assert jax.tree_util.tree_unflatten(treedef, leaves).layout == st.layout

    ts = make_track_state(48, 64, n_pts=8, max_lines=4, max_obs=3)
    assert len(jax.tree.leaves(ts)) == len(dataclasses.fields(TrackState))
