"""Inputs made from the seed: training batches and the served requests.

Training batch ``i`` is drawn on the device from its own generator, so the
reference draws the same rows again. The served traffic is an open loop
whose sizes and gaps are the same for every seed: ``n`` gaps at the
quantiles of an exponential distribution of the mix's rate, and ``n``
prompt lengths at the quantiles of its lognormal, each list put in an
order drawn from the seed that gives every few seconds of the window its
share of short and long. A seed changes the order of the work, never its
amount, and no seed piles the long prompts into one stretch.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List

import numpy as np
import torch

from portbench.weights import MASK64, group_seed

BATCH_GROUP = 1 << 20     # generator groups of the batches, past the weights'


def batch(c: Dict, traffic: Dict, seed: int, index: int, device) -> Dict:
    """Training batch ``index``: ``tokens`` [B, S] for a decoder, ``images``
    [B, H, W, C] and ``labels`` [B] for a ViT."""
    gen = torch.Generator(device=device).manual_seed(
        group_seed(seed, BATCH_GROUP + index))
    b = traffic["batch"]
    if c["model"] == "decoder":
        return {"tokens": torch.randint(
            0, c["vocab_size"], (b, traffic["seq_len"]), generator=gen,
            dtype=torch.int64, device=device)}
    size, ch = c["image_size"], c["num_channels"]
    images = torch.randn((b, size, size, ch), generator=gen,
                         dtype=torch.float32, device=device)
    labels = torch.randint(0, c["num_labels"], (b,), generator=gen,
                           dtype=torch.int64, device=device)
    return {"images": images, "labels": labels}


def tokens_per_step(c: Dict, traffic: Dict) -> int:
    """Tokens a training step takes: a decoder's B x S; a ViT's patches,
    B x (size / patch)^2 (the repo's ViT has no class token)."""
    if c["model"] == "decoder":
        return traffic["batch"] * traffic["seq_len"]
    return traffic["batch"] * (c["image_size"] // c["patch_size"]) ** 2


@dataclasses.dataclass
class Request:
    index: int
    due_s: float            # from the start of the window
    tokens: np.ndarray      # int32 [L]


def _quantiles(n: int):
    return [(i + 0.5) / n for i in range(n)]


def prompt_lengths(traffic: Dict, n: int) -> List[int]:
    """The ``n`` prompt lengths of the mix before shuffling: lognormal
    quantiles, clipped and rounded up to a multiple."""
    spec = traffic["length"]
    mu, sigma = math.log(spec["median"]), spec["sigma"]
    unit = spec["multiple"]
    out = []
    for q in _quantiles(n):
        x = math.exp(mu + sigma * statistics.NormalDist().inv_cdf(q))
        x = min(max(x, spec["min"]), spec["max"])
        out.append(int(math.ceil(x / unit)) * unit)
    return out


def _stratified(values: List, segments: int, rng) -> List:
    """``values`` (sorted) in a random order in which every segment of
    the sequence holds one value of each band of ``segments`` neighbours:
    each segment gets the same share of small and large values."""
    out: List[List] = [[] for _ in range(segments)]
    for b in range(0, len(values), segments):
        band = values[b:b + segments]
        for value, seg in zip(band, rng.permutation(segments)):
            out[int(seg)].append(value)
    for seg in out:
        rng.shuffle(seg)
    return [v for seg in out for v in seg]


def requests(c: Dict, traffic: Dict, seed: int, seconds: float,
             rate: float = None) -> List[Request]:
    """The open loop of one run: ``round(rate * seconds)`` requests due
    from 0 on, at the mix's rate unless ``rate`` is given. The gaps and
    the lengths are each spread over segments of about ``segment_s``
    seconds, every segment with its share of each."""
    rate = traffic["rate_per_s"] if rate is None else rate
    n = max(1, round(rate * seconds))
    segments = max(1, round(seconds / traffic["segment_s"]))
    rng = np.random.default_rng(seed & MASK64)
    gaps = _stratified([-math.log1p(-q) / rate for q in _quantiles(n)],
                       segments, rng)
    lengths = _stratified(prompt_lengths(traffic, n), segments, rng)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return [Request(i, float(due[i]),
                    rng.integers(0, c["vocab_size"], int(lengths[i]),
                                 dtype=np.int32))
            for i in range(n)]


def warm_shapes(traffic: Dict) -> List[tuple]:
    """(rows, length) of every batch shape the mix can send, as few as
    cover each: every row count at the longest length, and every length
    in one row."""
    spec = traffic["length"]
    longest = int(math.ceil(spec["max"] / spec["multiple"])) * spec["multiple"]
    lengths = range(int(math.ceil(spec["min"] / spec["multiple"]))
                    * spec["multiple"], longest + 1, spec["multiple"])
    rows = range(1, traffic["max_batch_size"] + 1)
    return [(r, longest) for r in rows] + [(1, s) for s in lengths
                                            if s != longest]
