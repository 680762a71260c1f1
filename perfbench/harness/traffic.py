"""The one traffic generator: a mix's parameters in, the window's requests out.

A mix is a JSON file under ``perfbench/traffic/`` (``load_mix``).  A cell's
mix names its offered rate and may ``extends`` a base mix whose
parameters it inherits.  ``generate(mix, seed, seconds)`` returns one
``Req`` per request sent in ``[0, seconds)``.

What the seed changes, and what it does not.  The set of work is drawn
once from the mix's own ``shape_seed``: how many requests the window
holds (``round(rate * seconds)``), their gaps between sends (a Poisson
process conditioned on that count: sorted uniform send times), their
prompt and answer lengths, and the 4G bandwidth trace.  The run's seed
draws every prompt id and where the sequence of (gap, prompt, answer)
starts: it begins at a drawn request and wraps around, so which
requests arrive together stays as drawn.  Every seed sends the same
work, and a tail does not swing with which long prompts a reordering
puts into one burst.

Copied from the program, so that a later change there cannot move the
yardstick: the bounded log-normal lengths (``lognormal_lengths``), the
log-space Ornstein-Uhlenbeck 4G trace with regime shifts and fades
(``synth_4g_trace``) and the payload-over-bandwidth comm latency
(``comm_latency_many``) of ``repro_torch.serving`` / ``repro_torch.network``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parents[1] / "traffic"

# every key a complete mix holds
MIX_KEYS = ("rate_rps", "shape_seed", "prompt", "decode", "bucket",
            "max_decode", "ttft_slo_s", "tbt_slo_s", "bytes_per_token",
            "b_set", "c_set", "tick_s")


@dataclasses.dataclass(frozen=True)
class Req:
    """One request of the window.  Times are seconds from the window's
    opening; ``arrival = send + comm_latency`` is when the server sees it,
    and its first token is due by ``send + ttft_slo``."""
    index: int
    send: float
    comm_latency: float
    prompt: np.ndarray          # int32 ids, length = prompt_tokens
    decode_tokens: int          # tokens streamed after the first
    ttft_slo: float
    tbt_slo: float
    size_kb: float = 1.0        # the payload on the wire

    @property
    def arrival(self) -> float:
        return self.send + self.comm_latency

    @property
    def prompt_tokens(self) -> int:
        return int(self.prompt.size)


def load_mix(name: str, root: Path = TRAFFIC_DIR) -> dict:
    """The parameters of mix ``name`` (``<root>/<name>.json``), with those
    of the mix it ``extends`` underneath; a complete mix holds every key
    of ``MIX_KEYS``."""
    path = root / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} at {path}")
    own = json.loads(path.read_text())
    base = own.pop("extends", None)
    mix = dict(load_mix(base, root)) if base else {}
    mix.update(own)
    mix["name"] = name
    return mix


def check_mix(mix: dict) -> None:
    missing = [k for k in MIX_KEYS if k not in mix]
    if missing:
        raise ValueError(f"mix {mix.get('name')!r} lacks {missing}")
    if mix["prompt"]["hi"] > mix["bucket"]:
        raise ValueError("the prompt bucket must hold the longest prompt")
    if mix["decode"]["hi"] > mix["max_decode"]:
        raise ValueError("max_decode must hold the longest answer")


def lognormal_lengths(rng: np.random.Generator, n: int, median: float,
                      sigma: float, lo: int, hi: int) -> np.ndarray:
    """Bounded log-normal token lengths: exp(N(log median, sigma)) rounded
    and clipped to [lo, hi]."""
    x = rng.lognormal(mean=np.log(median), sigma=sigma, size=n)
    return np.clip(np.round(x), lo, hi).astype(np.int64)


def synth_4g_trace(duration_s: int, seed: int, lo: float = 0.5,
                   hi: float = 7.0, fade_depth=(0.15, 0.3)) -> np.ndarray:
    """Bandwidth in MB/s, one sample a second: log-space Ornstein-Uhlenbeck
    with regime shifts every 45-150 s and a few deep fades."""
    rng = np.random.default_rng(seed)
    n = int(duration_s)
    x = np.zeros(n)
    mu = np.log(2.5)
    x[0] = mu
    theta, sigma = 0.05, 0.25
    n_regimes = max(20, n // 90 + 1)
    shift_times = np.cumsum(rng.integers(45, 150, size=n_regimes))
    shifts = {int(t): rng.uniform(np.log(lo * 1.6), np.log(hi * 0.8))
              for t in shift_times if t < n}
    for i in range(1, n):
        if i in shifts:
            mu = shifts[i]
        x[i] = x[i - 1] + theta * (mu - x[i - 1]) + sigma * rng.normal()
    bw = np.exp(x)
    if n > 20:
        n_fades = int(rng.integers(2, 5)) if n <= 1200 else n // 250
        for _ in range(n_fades):
            s = rng.integers(0, n - 15)
            bw[s:s + rng.integers(4, 12)] *= rng.uniform(*fade_depth)
    return np.clip(bw, lo, hi)


def comm_latency_many(size_kb: np.ndarray, mbps: np.ndarray,
                      times: np.ndarray, rtt_s: float = 0.02) -> np.ndarray:
    """Payload over the bandwidth at the send second, plus the round trip."""
    idx = np.clip(np.asarray(times, np.float64).astype(np.int64), 0,
                  len(mbps) - 1)
    return rtt_s + (np.asarray(size_kb, np.float64) / 1024.0) / np.maximum(
        mbps[idx], 1e-6)


def generate(mix: dict, seed: int, seconds: float,
             vocab_size: int) -> List[Req]:
    """The requests sent in ``[0, seconds)`` (module docstring)."""
    check_mix(mix)
    shape = np.random.default_rng(int(mix["shape_seed"]))
    n = max(1, int(round(mix["rate_rps"] * seconds)))
    sends = np.sort(shape.uniform(0.0, seconds, n))
    gaps = np.diff(np.concatenate([[0.0], sends]))
    p, d = mix["prompt"], mix["decode"]
    prompt = lognormal_lengths(shape, n, p["median"], p["sigma"], p["lo"],
                               p["hi"])
    decode = lognormal_lengths(shape, n, d["median"], d["sigma"], d["lo"],
                               d["hi"])
    mbps = synth_4g_trace(int(seconds) + 5, int(shape.integers(2**31)))

    rng = np.random.default_rng(int(seed))
    k = int(rng.integers(n))
    gaps, prompt, decode = (np.roll(a, -k) for a in (gaps, prompt, decode))
    sends = np.minimum(np.cumsum(gaps), np.nextafter(seconds, 0.0))
    size_kb = np.maximum(prompt * mix["bytes_per_token"] / 1000.0, 1.0)
    cl = comm_latency_many(size_kb, mbps, sends)
    return [Req(index=i, send=float(sends[i]), comm_latency=float(cl[i]),
                prompt=rng.integers(0, vocab_size, int(prompt[i]))
                .astype(np.int32),
                decode_tokens=int(decode[i]),
                ttft_slo=float(mix["ttft_slo_s"]),
                tbt_slo=float(mix["tbt_slo_s"]), size_kb=float(size_kb[i]))
            for i in range(n)]
