"""Finding the benchmark's pieces by name.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own under the benchmark's
folder, and is found from the name `BENCHMARK.json` gives it:

- `configs/<config>.json`: the model's published sizes (Hugging Face
  key names), its source, `reduced` and `assumed`;
- `traffic/<mix>.json`: a generator `kind` and its parameters; the kind
  is the module `traffic/<kind>.py`;
- `cells/<cell>.json`: the config, the traffic, the policy, the engine's
  deployment settings, the correctness check and `why`;
- `metrics/<metric>.py`: the reader of one per-layer metric.

Adding a cell, a configuration, a mix or a metric is adding files; no
file here lists them. Plain JSON and the standard library only: the
reference and the tests import this without torch.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def read_json(kind: str, name: str, root: Path = ROOT) -> dict:
    """`<root>/<kind>/<name>.json`, or a ValueError naming what is
    missing."""
    path = root / kind / f"{_check_name(name)}.json"
    if not path.is_file():
        raise ValueError(f"no {kind[:-1]} named {name!r} ({path})")
    with path.open() as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = ROOT):
    """The module `<root>/<kind>/<name>.py`, loaded from its file (a
    reader or a traffic kind that a later change adds is found here
    without a registry)."""
    path = (root / kind / f"{_check_name(name)}.py").resolve()
    if not path.is_file():
        raise ValueError(f"no {kind} module named {name!r} ({path})")
    key = f"portbench._found.{kind}.{name}@{path}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


@dataclasses.dataclass(frozen=True)
class Model:
    """The sizes of a configuration file, under the names the benchmark
    computes with (the reference, the weights and the reckoning of
    FLOPs and bytes read these, never the port's config)."""
    name: str
    arch: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int                  # dense MLP width (0 for an MoE)
    vocab: int
    rope_theta: float
    norm_eps: float
    n_experts: int = 0
    n_experts_padded: int = 0
    top_k: int = 0
    d_ff_expert: int = 0

    @property
    def moe(self) -> bool:
        return self.n_experts > 0


def model_of(cfg: dict) -> Model:
    """The `Model` a configuration file states."""
    moe = "num_local_experts" in cfg
    heads = cfg["num_attention_heads"]
    assumed = cfg.get("assumed", {})
    return Model(
        name=cfg["name"], arch=cfg["arch"],
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=heads, n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or cfg["hidden_size"] // heads,
        d_ff=0 if moe else cfg["intermediate_size"],
        vocab=cfg["vocab_size"], rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]),
        n_experts=cfg.get("num_local_experts", 0),
        n_experts_padded=assumed.get("experts_padded_to",
                                     cfg.get("num_local_experts", 0)),
        top_k=cfg.get("num_experts_per_tok", 0),
        d_ff_expert=cfg["intermediate_size"] if moe else 0)


@dataclasses.dataclass
class Cell:
    """One cell, with its configuration and traffic files read."""
    name: str
    body: dict
    config: dict
    traffic: dict

    @property
    def model(self) -> Model:
        return model_of(self.config)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    body = read_json("cells", name, root)
    return Cell(name, body, read_json("configs", body["config"], root),
                read_json("traffic", body["traffic"], root))


def load_benchmark(path: Path) -> dict:
    with Path(path).open() as f:
        return json.load(f)


def metric_entries(bench: dict, section: str, cell: str) -> list[dict]:
    """The `section` metrics ("end_to_end" or "per_layer") that `cell`
    reports: those without a `workloads` key, and those that list it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]
