"""Cartesian <-> polyspherical transforms over a branching tree.

Replaces `ultrasphere.to_cartesian` / `from_cartesian` (reference call
sites: _biem.py:613, :885, plot.py:72-77).  The tree is static, so the
recursion unrolls at trace time into pure elementwise JAX ops (sin/cos/
atan2/hypot) that XLA fuses.

Spherical mappings are dicts {node_id: angle_array, "r": radius_array};
cartesian arrays put the vector axis FIRST: shape [c_ndim, ...], matching
the reference convention (reference: _biem.py:107-128).
"""

import jax.numpy as jnp


def to_cartesian(c, spherical, as_array=True, include_r=True):
    """Map angles (+ optional radius) to cartesian coordinates [c_ndim, ...].

    If "r" is missing or include_r is False, points are on the unit sphere.
    """
    r = spherical.get("r") if include_r else None
    factors = {}  # axis -> list of multiplicative terms

    def walk(node, prefix):
        if node.kind == "a":
            phi = spherical[node.nid]
            factors[node.axes[0]] = prefix + [jnp.cos(phi)]
            factors[node.axes[1]] = prefix + [jnp.sin(phi)]
            return
        th = spherical[node.nid]
        if node.kind in ("b", "bp"):
            factors[node.axis] = prefix + [jnp.cos(th)]
            walk(node.children[0], prefix + [jnp.sin(th)])
            return
        walk(node.children[0], prefix + [jnp.cos(th)])
        walk(node.children[1], prefix + [jnp.sin(th)])

    walk(c.root, [] if r is None else [r])

    parts = []
    for axis in range(c.c_ndim):
        v = factors[axis][0]
        for t in factors[axis][1:]:
            v = v * t
        parts.append(v)
    parts = jnp.broadcast_arrays(*parts)
    if as_array:
        return jnp.stack(parts, axis=0)
    return {i: p for i, p in enumerate(parts)}


def from_cartesian(c, x):
    """Map cartesian [c_ndim, ...] to {node_id: angle, "r": radius}."""
    x = jnp.asarray(x)
    if x.shape[0] != c.c_ndim:
        raise ValueError(
            f"leading axis of x must be c_ndim={c.c_ndim}, got {x.shape[0]}"
        )
    out = {}

    def walk(node):
        """Returns the norm of the node's axes sub-vector."""
        if node.kind == "a":
            xi, xj = x[node.axes[0]], x[node.axes[1]]
            out[node.nid] = jnp.arctan2(xj, xi)
            return jnp.hypot(xi, xj) if not jnp.iscomplexobj(xi) else jnp.sqrt(
                xi * xi + xj * xj
            )
        if node.kind in ("b", "bp"):
            rc = walk(node.children[0])
            xa = x[node.axis]
            out[node.nid] = jnp.arctan2(rc, xa)
            return jnp.hypot(rc, xa)
        r1 = walk(node.children[0])
        r2 = walk(node.children[1])
        out[node.nid] = jnp.arctan2(r2, r1)
        return jnp.hypot(r1, r2)

    out["r"] = walk(c.root)
    return out
