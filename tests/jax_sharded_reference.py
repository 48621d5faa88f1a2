"""The JAX package's side of tests/test_torch_sharded.py's shard-for-shard
test, run in its own process (not by pytest directly):

    python tests/jax_sharded_reference.py STATE.npz OUT.npz

Reads a sharded start state (a ShardedMapState's numpy columns and counts,
the mapper's last depth and pose, the camera, the settings and the frames
to run), runs ``make_sharded_step`` on a mesh of as many virtual CPU devices
as the state has shards, and writes the final columns and counts and each
frame's stats.

    python tests/jax_sharded_reference.py --long-run D [D ...]

prints the live count of tests/test_sharded.py's long run (20 frames of
removals) through the JAX package's single-card SurfelMapper and its
ShardedMapper on D devices, for each D given.

The caller sets ``XLA_FLAGS`` (the device count, and ``--xla_cpu_max_isa``)
before JAX starts, which is why this runs in a process of its own.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from surfelmapping_tpu.config import PipelineParams  # noqa: E402
from surfelmapping_tpu.io.synthetic import SyntheticScene, tiny_cam  # noqa: E402
from surfelmapping_tpu.parallel import sharded  # noqa: E402

COLS = ("px", "py", "pz", "conf", "colorsem", "init_t", "last_t", "nx", "ny", "nz", "radius")


def main(state_path: str, out_path: str) -> int:
    z = np.load(state_path)
    D = len(z["counts"])
    mesh = Mesh(np.array(jax.devices()[:D]), (sharded.AXIS,))
    state = sharded.ShardedMapState(**{k: jnp.asarray(z[k]) for k in COLS},
                                    counts=jnp.asarray(z["counts"]))
    state = jax.device_put(state, sharded.state_sharding(mesh))
    cam = tiny_cam(int(z["width"]), int(z["height"]))
    step = sharded.make_sharded_step(
        mesh, cam, PipelineParams(fuse_thresh_factor=float(z["fuse_thresh"])), D,
        active_blocks=int(z["active_blocks"]), block_size=int(z["block_size"]))
    scene = SyntheticScene(cam)
    last_depth, last_pose = jnp.asarray(z["last_depth"]), jnp.asarray(z["last_pose"])
    rows = []
    first = int(z["first"])
    for i in range(first, first + int(z["frames"])):
        rgb, d, s, T = scene.frame(i)
        state, last_depth, stats = step(
            state, jnp.asarray(d), jnp.asarray(rgb, jnp.float32) / 255.0,
            jnp.asarray(s.astype(np.int32)), jnp.asarray(T, jnp.float32), last_depth,
            last_pose, jnp.float32(i))
        last_pose = jnp.asarray(T, jnp.float32)
        rows.append([int(stats[k]) for k in ("removed", "merged", "dropped", "new", "count")]
                    + list(np.asarray(stats["live_per_dev"])))
    np.savez(out_path, counts=np.asarray(state.counts), stats=np.array(rows),
             last_depth=np.asarray(last_depth),
             **{k: np.asarray(getattr(state, k)) for k in COLS})
    return 0


def long_run(*ranks: str) -> int:
    from surfelmapping_tpu.config import MapConfig
    from surfelmapping_tpu.pipeline import SurfelMapper

    cam, params = tiny_cam(128, 64), PipelineParams(stereo_border=0.0)
    single = SurfelMapper(cam, params, MapConfig(capacity=1 << 16), sync_every=4)
    mappers = {"single": single}
    for d in map(int, ranks):
        mesh = Mesh(np.array(jax.devices()[:d]), (sharded.AXIS,))
        mappers[f"D={d}"] = sharded.ShardedMapper(mesh, cam, params, capacity=1 << 13,
                                                  active_blocks=8, block_size=128,
                                                  sync_every=4, compact_dead_frac=0.2)
    scene = SyntheticScene(cam, step=0.6)
    for i in range(20):
        frame = scene.frame(i)
        for m in mappers.values():
            m.process_frame(*frame)
    print(" ".join(f"{k}: {m.count}" for k, m in mappers.items()), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--long-run"]:
        sys.exit(long_run(*sys.argv[2:]))
    sys.exit(main(*sys.argv[1:]))
