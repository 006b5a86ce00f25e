"""The one traffic generator: every mix is a data file under
``portbench/traffic/`` that this module reads.

A mix fixes a set of sizes per cycle and every seed serves that same set
in another order, so that two seeds ask the same work of the card:

* ``sizes_per_cycle`` strata of the length distributions: stratum i takes
  the quantile (i + 1/2) / N of ``total_tokens`` (``loguniform`` or
  ``uniform`` between ``lo`` and ``hi``) and, through the fixed scramble
  ``(i * pairing_stride) mod N``, a quantile of ``output_tokens``. With
  ``minus_output`` the drawn total is prompt plus output, else the prompt
  alone.
* Each cycle serves the strata in the fixed order ``(i * order_stride)
  mod N``; the seed draws the token ids (uniform over the vocabulary).
  The sizes, their order and the arrivals are the mix's and the same for
  every seed (as is the simulation's seed, ``sim_seed``), so that every
  seed asks the same work of the card; the seed changes what is computed,
  not how much. With ``turns`` > 1 consecutive strata of a cycle form
  sessions of that many turns, each turn's prompt the previous turn's
  prompt followed by new tokens (a chat carrying its history).
* Routed mixes (``entry`` ``routed``) arrive open-loop in the simulated
  clock, one every ``arrival_gap_s``. Engine mixes (``entry`` ``engine``)
  come as closed-loop static batches of ``batch`` requests sharing one
  prompt length (the stratum's total less the largest output), each
  request with one of the output strata.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


@dataclass
class Item:
    """One request: its prompt, how many tokens it asks for, and its
    arrival in the simulated clock (routed mixes; 0 for the engine)."""
    prompt: np.ndarray
    max_new_tokens: int
    arrival_s: float = 0.0


def load(name: str) -> Dict:
    """The mix ``name`` (``portbench/traffic/<name>.json``)."""
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no traffic file {path}")
    return json.loads(path.read_text())


def _quantile(spec: Dict, q: float) -> int:
    lo, hi = float(spec["lo"]), float(spec["hi"])
    if spec["dist"] == "loguniform":
        return int(round(lo * (hi / lo) ** q))
    if spec["dist"] == "uniform":
        return int(min(hi, lo + math.floor(q * (hi - lo + 1))))
    raise ValueError(f"unknown distribution {spec['dist']!r}")


def _stride(mix: Dict, key: str, n: int) -> List[int]:
    stride = int(mix.get(key, 1))
    if math.gcd(stride, n) != 1:
        raise ValueError(f"{key} must be coprime with the strata")
    return [(i * stride) % n for i in range(n)]


def strata(mix: Dict) -> List[tuple]:
    """The cycle's (total, output) sizes, in serving order."""
    n = int(mix["sizes_per_cycle"])
    pair = _stride(mix, "pairing_stride", n)
    outs = [_quantile(mix["output_tokens"], (i + 0.5) / n) for i in range(n)]
    sizes = [(_quantile(mix["total_tokens"], (i + 0.5) / n), outs[pair[i]])
             for i in range(n)]
    return [sizes[i] for i in _stride(mix, "order_stride", n)]


def _rng(seed: int, cycle: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), int(cycle)])


def routed_cycle(mix: Dict, seed: int, cycle: int, vocab: int,
                 first_index: int) -> List[Item]:
    """Cycle ``cycle`` of a routed mix: ``sizes_per_cycle`` requests
    arriving one per gap from request ``first_index`` on, token ids from
    the seed."""
    rng = _rng(seed, cycle)
    sizes = strata(mix)
    turns = int(mix.get("turns", 1))
    minus = bool(mix["total_tokens"].get("minus_output", False))
    sessions = [sorted(sizes[s:s + turns],
                       key=lambda t: t[0] - (t[1] if minus else 0))
                for s in range(0, len(sizes), turns)]
    items: List[Item] = []
    last = [np.zeros((0,), np.int32) for _ in sessions]
    gap = float(mix["arrival_gap_s"])
    for t in range(turns):
        for s, sess in enumerate(sessions):
            if t >= len(sess):
                continue
            total, out = sess[t]
            plen = total - out if minus else total
            fresh = rng.integers(0, vocab, size=plen - len(last[s]),
                                 dtype=np.int64).astype(np.int32)
            last[s] = np.concatenate([last[s], fresh])
            idx = first_index + len(items)
            items.append(Item(last[s], out, idx * gap))
    return items


def engine_cycle(mix: Dict, seed: int, cycle: int,
                 vocab: int) -> List[List[Item]]:
    """Cycle ``cycle`` of an engine mix: one static batch per stratum of
    ``total_tokens`` in the mix's order; each batch holds ``batch``
    requests of one prompt length, one per output stratum, token ids from
    the seed."""
    rng = _rng(seed, cycle)
    n = int(mix["sizes_per_cycle"])
    b = int(mix["batch"])
    totals = [_quantile(mix["total_tokens"], (i + 0.5) / n)
              for i in range(n)]
    outs = [_quantile(mix["output_tokens"], (j + 0.5) / b) for j in range(b)]
    minus = bool(mix["total_tokens"].get("minus_output", False))
    batches: List[List[Item]] = []
    for i in _stride(mix, "order_stride", n):
        plen = totals[i] - max(outs) if minus else totals[i]
        batch = []
        for j in range(b):
            prompt = rng.integers(0, vocab, size=plen,
                                  dtype=np.int64).astype(np.int32)
            batch.append(Item(prompt, outs[j]))
        batches.append(batch)
    return batches
