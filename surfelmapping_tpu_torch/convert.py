"""Carry state between the JAX package and the port, through numpy.

The mapper has no weights: what carries over is the surfel map, the
mapper's running state (last filtered depth, last pose, tick), an active
table and a BA window.  Columns are read out of the JAX dataclasses with
``np.asarray``; a float32 ``colorsem`` column becomes the port's int32 bits
by ``.view``, never by arithmetic, so subnormal colors survive.

The SPADE GAN's weights carry over as flax variables, in both directions:
nested dicts of numpy arrays, ``{"params": ..., "batch_stats": ...}``.
:func:`flax_layout` is the one place where the port's tensors are named
after flax's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn

from .ba import BAWindow
from .models.spade import SNConv2d, SPADENorm, build_modules, spectral_normalize
from .ops.active import ActiveTable
from .surfels import COLUMNS, SurfelMap, empty_map


def map_from_numpy(cols: dict[str, np.ndarray], count: int,
                   device: torch.device | str) -> SurfelMap:
    """The port's map from numpy columns of one capacity (colorsem as
    float32 or int32 bits)."""
    cap = len(cols["px"])
    m = empty_map(cap, device)
    for k in COLUMNS:
        a = np.array(cols[k], copy=True)  # writable, contiguous
        a = a.view(np.int32) if k == "colorsem" else a.astype(np.float32, copy=False)
        getattr(m, k)[:cap] = torch.from_numpy(a).to(device)
    m.count = torch.tensor(int(count), dtype=torch.int32, device=device)
    return m


def map_to_numpy(smap: SurfelMap) -> tuple[dict[str, np.ndarray], int]:
    """(columns, count) with colorsem as float32 bits, the JAX map's dtype."""
    cols = {k: smap.column(k).cpu().numpy() for k in COLUMNS}
    cols["colorsem"] = cols["colorsem"].view(np.float32)
    return cols, int(smap.count)


def mapper_state_from_numpy(mapper, cols: dict[str, np.ndarray], count: int,
                            last_depth: np.ndarray, last_pose: np.ndarray,
                            tick: int) -> None:
    """Put a mapper (surfelmapping_tpu_torch.pipeline.SurfelMapper) in the
    state another mapper left: its map, last filtered depth, last pose and
    tick.  The next frame then takes the same path on both."""
    dev = mapper.device
    mapper.smap = map_from_numpy(cols, count, dev)
    mapper.last_depth = torch.from_numpy(np.array(last_depth, np.float32)).to(dev)
    mapper.last_pose = torch.from_numpy(np.array(last_pose, np.float32)).to(dev)
    mapper.tick = int(tick)
    mapper.ref_frame_set = True
    mapper._clear_window()
    mapper._refresh_counts()


def table_from_numpy(cols: dict[str, np.ndarray], device: torch.device | str) -> ActiveTable:
    """The port's ActiveTable from numpy columns (a JAX ActiveTable's fields;
    colorsem as float32 or int32 bits, ids widened to int64)."""
    out = {}
    for f in dataclasses.fields(ActiveTable):
        a = np.array(cols[f.name], copy=True)
        if f.name == "colorsem":
            a = a.view(np.int32)
        elif f.name in ("global_id", "blk"):
            a = a.astype(np.int64)
        elif f.name != "slot_valid":
            a = a.astype(np.float32, copy=False)
        out[f.name] = torch.from_numpy(a).to(device)
    return ActiveTable(**out)


_WINDOW_ARRAYS = ("poses", "v_c", "n_c", "valid", "odo", "prior_H", "prior_b", "prior_T0")


def window_from_numpy(arrays: dict[str, np.ndarray], n_valid: int,
                      device: torch.device | str) -> BAWindow:
    """The port's BAWindow from numpy arrays (a JAX BAWindow's fields)."""
    return BAWindow(**{k: torch.from_numpy(np.array(arrays[k], copy=True)).to(device)
                       for k in _WINDOW_ARRAYS}, n_valid=int(n_valid))


def window_to_numpy(win: BAWindow) -> tuple[dict[str, np.ndarray], int]:
    """(arrays, n_valid) of a BAWindow, the JAX BAWindow's fields and dtypes
    (n_valid becomes int32 there)."""
    return {k: getattr(win, k).cpu().numpy() for k in _WINDOW_ARRAYS}, win.n_valid


# -- SPADE weights ------------------------------------------------------------

# flax's lecun_normal: a normal truncated to two deviations, scaled so the
# truncated draw has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class FlaxSlot:
    """One flax variable of a port module: the module's state_dict ``key``
    that it fills, its ``collection`` and ``path`` in the flax tree, its
    ``shape`` there, and its ``kind``
    (conv: HWIO kernel of an OIHW weight; dense: (in, out) kernel of an
    (out, in) weight; bias; mean and var of a SPADE norm; u and sigma of a
    SpectralNorm).  A spectral-normed kernel also names its ``u_path``."""

    key: str | None
    collection: str
    path: tuple[str, ...]
    shape: tuple[int, ...]
    kind: str
    u_path: tuple[str, ...] | None = None


def flax_layout(module: nn.Module) -> list[FlaxSlot]:
    """Every flax variable of ``module`` (a models.spade or models.losses
    module, or an ``nn.ModuleDict`` of them, on any device).  The port's
    submodules carry the flax names, so a module path is a flax path; a
    spectral-normed conv's state lives in its parent's ``SpectralNorm_<k>``
    under ``<conv>/kernel/{u,sigma}``, k its place in the parent's
    ``SN_CONVS``."""
    slots = []
    for name, mod in module.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            u_path = None
            if isinstance(mod, SNConv2d):
                parent = module.get_submodule(".".join(path[:-1]))
                sn = path[:-1] + (f"SpectralNorm_{parent.SN_CONVS.index(path[-1])}",)
                u_path = sn + (f"{path[-1]}/kernel/u",)
                slots += [FlaxSlot(f"{name}.u", "batch_stats", u_path, (1, w.shape[0]), "u"),
                          FlaxSlot(f"{name}.sigma", "batch_stats",
                                   sn + (f"{path[-1]}/kernel/sigma",), (), "sigma")]
            if isinstance(mod, nn.Conv2d):
                slots.append(FlaxSlot(f"{name}.weight", "params", path + ("kernel",),
                                      tuple(w.shape[2:]) + (w.shape[1], w.shape[0]), "conv",
                                      u_path))
            else:
                slots.append(FlaxSlot(f"{name}.weight", "params", path + ("kernel",),
                                      (w.shape[1], w.shape[0]), "dense"))
            if mod.bias is not None:
                slots.append(FlaxSlot(f"{name}.bias", "params", path + ("bias",),
                                      tuple(mod.bias.shape), "bias"))
        elif isinstance(mod, SPADENorm):
            for stat in ("mean", "var"):
                slots.append(FlaxSlot(f"{name}.{stat}".lstrip("."), "batch_stats",
                                      path + ("BatchNorm_0", stat), tuple(mod.mean.shape), stat))
    return slots


def _leaf(tree: dict, path: tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def init_numpy(module: nn.Module, gen: torch.Generator) -> dict:
    """Flax variables for ``module`` drawn as flax initialises them, from
    the generator ``gen``: lecun-normal kernels, zero biases, u ~ N(0, 1),
    sigma 1, running mean 0 and variance 1."""
    tree: dict = {"params": {}, "batch_stats": {}}
    for s in flax_layout(module):
        if s.kind in ("conv", "dense"):
            std = math.sqrt(1.0 / math.prod(s.shape[:-1])) / _TRUNC_STD
            t = torch.empty(s.shape)
            nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        elif s.kind == "u":
            t = torch.randn(s.shape, generator=gen)
        else:
            t = torch.ones(s.shape) if s.kind in ("var", "sigma") else torch.zeros(s.shape)
        node = tree[s.collection]
        for k in s.path[:-1]:
            node = node.setdefault(k, {})
        node[s.path[-1]] = t.numpy()
    return tree


def torch_tensors(module: nn.Module, variables: dict, normalize: bool = False,
                  collections: tuple[str, ...] = ("params", "batch_stats")
                  ) -> dict[str, torch.Tensor]:
    """``module``'s state_dict entries of the given flax ``collections``
    from the flax ``variables``, in the port's layout, on the CPU.  With
    ``normalize``, spectral-normed kernels come divided by their sigma."""
    state = {}
    for s in flax_layout(module):
        if s.collection not in collections:
            continue
        a = torch.from_numpy(np.array(_leaf(variables[s.collection], s.path), np.float32))
        if normalize and s.u_path is not None:
            u = torch.from_numpy(np.array(_leaf(variables["batch_stats"], s.u_path), np.float32))
            a = spectral_normalize(a, u)
        if s.kind == "conv":
            a = a.permute(3, 2, 0, 1)
        elif s.kind == "dense":
            a = a.T
        state[s.key] = a.contiguous()
    return state


def load_numpy(module: nn.Module, variables: dict, device: torch.device | str,
               trainable: bool = False) -> nn.Module:
    """``module`` (built on the meta device) with its weights from the flax
    ``variables``, on ``device``, in eval mode.  For inference (the
    default) spectral-normed kernels are divided by their sigma here, once,
    and no parameter takes a gradient; ``trainable`` keeps the raw kernels,
    whose convolutions then normalize on every call (``SNConv2d``)."""
    module.load_state_dict(torch_tensors(module, variables, normalize=not trainable),
                           strict=True, assign=True)
    for m in module.modules():
        if isinstance(m, SNConv2d):
            m.normalized = not trainable
    return module.to(device).requires_grad_(trainable).eval()


def to_numpy(module: nn.Module, tensors: dict[str, torch.Tensor] | None = None,
             collections: tuple[str, ...] = ("params", "batch_stats")) -> dict:
    """Flax variables of the given ``collections`` from a trainable
    ``module``'s state (or from ``tensors``, keyed and shaped as its
    state_dict: an optimizer's moments), in flax's layout, as numpy."""
    if any(isinstance(m, SNConv2d) and m.normalized for m in module.modules()):
        raise ValueError("to_numpy: a spectral-normed kernel was divided by its sigma at "
                         "load; load the module with trainable=True")
    tensors = module.state_dict() if tensors is None else tensors
    tree: dict = {c: {} for c in collections}
    for s in flax_layout(module):
        if s.collection not in collections:
            continue
        a = tensors[s.key].detach()
        if s.kind == "conv":
            a = a.permute(2, 3, 1, 0)
        elif s.kind == "dense":
            a = a.T
        node = tree[s.collection]
        for k in s.path[:-1]:
            node = node.setdefault(k, {})
        node[s.path[-1]] = a.cpu().contiguous().numpy()
    return tree


def spade_from_numpy(variables: dict, cfg, device: torch.device | str):
    """(generator, encoder) of the port from flax variables: the generator's
    ``{"params", "batch_stats"}`` (or a TrainState's ``g_params`` and
    ``g_batch_stats``); with ``cfg.use_vae`` both hold ``gen`` and ``enc``
    (pix2pix.py:155-161), else the encoder is None.  ``cfg`` is a
    ``models.pix2pix.SpadeConfig``."""
    if "g_params" in variables:
        variables = {"params": variables["g_params"], "batch_stats": variables["g_batch_stats"]}
    gen, enc = build_modules(cfg, "meta")
    if enc is None:
        return load_numpy(gen, variables, device), None
    part = lambda name: {c: tree[name] for c, tree in variables.items()}  # noqa: E731
    return load_numpy(gen, part("gen"), device), load_numpy(enc, part("enc"), device)
