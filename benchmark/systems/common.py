"""What the system adapters share: the script's flags parsed by the
program's own option parser, the configuration checked against the
program's, and the benchmark's weights laid out as the program's
parameter tree."""

from __future__ import annotations

import types


def parse_flags(flags: list):
    """The program's parsed options for a launch script's flags (the
    scene comes from the benchmark, so --root_dir is a placeholder)."""
    from radnerf_tpu_torch.opt import get_opts

    return get_opts(["--root_dir", "generated", *flags])


def bare_system(cls, hparams):
    """An instance of the program's system class with its options and no
    data read from disk: enough for its train_config and trainer_hooks
    (steps per epoch as the NSVF loader states them)."""
    from radnerf_tpu_torch.data.base import BaseDataset

    s = cls.__new__(cls)
    s.h = hparams
    s.train_dataset = types.SimpleNamespace(
        STEPS_PER_EPOCH=BaseDataset.STEPS_PER_EPOCH)
    return s


def check_sizes(cfg, model: dict) -> None:
    """Raise where the program's field configuration is not the
    configuration file's (the file states what is run)."""
    pairs = {
        "n_levels": cfg.n_levels, "n_features": cfg.n_features,
        "log2_hashmap_size": cfg.log2_T, "base_resolution":
        cfg.base_resolution, "density_grid_size": cfg.grid_size,
        "geo_hidden": cfg.geo_hidden, "geo_layers": cfg.geo_layers,
        "geo_out": cfg.geo_out, "rgb_hidden": cfg.rgb_hidden,
        "rgb_layers": cfg.rgb_layers, "sh_degree": cfg.sh_degree,
        "scale": cfg.scale, "n_experts": cfg.n_experts,
    }
    wrong = {k: (v, model[k]) for k, v in pairs.items() if v != model[k]}
    if wrong:
        raise ValueError(f"the program runs other sizes than the "
                         f"configuration states: {wrong}")


def nest(flat: dict, prefix: str):
    """The leaves {path: tensor} under `prefix` as a tree of dicts and
    lists ('geo/w/0' -> {'geo': {'w': [...]}})."""
    tree: dict = {}
    for path, v in flat.items():
        if not path.startswith(prefix + "/"):
            continue
        keys = path[len(prefix) + 1:].split("/")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)
