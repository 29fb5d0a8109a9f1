"""Closed-loop serving traffic through the program's continuous-batching
engine (``serve.engine.ServeEngine``).

The mix file gives ``clients`` (each sends its next request as soon as its
previous one completes), ``engine`` (the engine's settings), ``prompt``
and ``output`` (the lengths' distributions) and ``grid``. The lengths are
a fixed multiset, ``grid`` quantiles of each distribution, that every seed
sends in an order of its own; the ids are uniform over the vocabulary and
drawn from the seed. Decoding is greedy (top-1), so the check can judge
every served token.

Set-up makes the weights on the card in bfloat16, builds the engine,
serves one request with the longest prompt (warming the prefill window,
its extensions and the decode chunk), then fills every slot with a first
wave whose outputs are spread from 17 tokens to the longest, so that
completions arrive staggered from the start, as they do in a loop that
has been running.

The window steps the engine until ``--seconds`` have passed. A request's
first token arrives at the end of the ``step()`` that admitted it (that
step also decodes its first chunk); its later tokens at the ends of the
steps after. After the window closes no request is sent, and the engine
steps on until every request sent in the window has its first token.
"""

from __future__ import annotations

import contextlib
import math
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import flops, weights
from portbench.reference import gpt as ref

FIRST_WAVE_MIN = 17  # two chunks of 16, so a first-wave request has a TPOT
LATE_S = 60.0  # how long past the close a first token may still arrive
TRACE_STEPS = 2  # the engine steps a traced run profiles


def length_grid(dist: Dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 0.5) / n of ``dist``: lognormal
    (``median``, ``sigma``) or uniform, clipped to [min, max]."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = dist["min"], dist["max"]
    if dist["dist"] == "lognormal":
        z = np.sqrt(2.0) * _erfinv(2.0 * u - 1.0)
        x = dist["median"] * np.exp(dist["sigma"] * z)
    elif dist["dist"] == "uniform":
        x = lo + u * (hi - lo + 1) - 0.5
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def _erfinv(y: np.ndarray) -> np.ndarray:
    return np.array([statistics.NormalDist().inv_cdf((v + 1.0) / 2.0)
                     / math.sqrt(2.0) for v in y])


class Traffic:
    """The seed's stream of requests: (prompt ids, output length)."""

    def __init__(self, mix: Dict, vocab: int, seed: int):
        self.rng = np.random.default_rng([int(seed), 23])
        n = int(mix["grid"])
        self.plens = self.rng.permutation(length_grid(mix["prompt"], n))
        self.olens = self.rng.permutation(length_grid(mix["output"], n))
        self.vocab, self.i = vocab, 0

    def next(self, out_len: int = 0):
        k = self.i % len(self.plens)
        self.i += 1
        prompt = self.rng.integers(0, self.vocab, int(self.plens[k]))
        return prompt.tolist(), int(out_len or self.olens[k])


@contextlib.contextmanager
def _span(name: str, on: bool):
    if not on:
        yield
        return
    from torch.profiler import record_function

    with record_function(name):
        yield


def flip_gap(g) -> float:
    """The number the check compares, of the served tokens' gaps ``g``
    below the reference's best logit: the mean over the tokens that are
    not the reference's best (0 with none; no tokens read: inf)."""
    if g is None or g.numel() == 0:
        return math.inf
    off = g > 0
    return float(g[off].mean()) if bool(off.any()) else 0.0


class Run:
    def __init__(self, cell: Dict, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg = cell["config"]
        self.shape, self.init = self.cfg["port"], self.cfg["init"]
        self.mix = cell["mix"]
        self.chunk = int(self.mix["engine"]["chunk"])
        self.reqs: Dict[int, Dict] = {}  # request id -> its record
        self.order: List[int] = []       # ids in submission order
        self.admitted = 0                # how many of ``order`` admitted
        self.live: List[int] = []        # admitted, not yet finished
        self.seen = 0                    # completions already read
        self.sending = True
        self.w_bytes = flops.weight_bytes(self.shape)
        self.row_bytes = flops.kv_row_bytes(self.shape) * self.shape[
            "n_layers"]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the program ----------------------------------------------------

    def setup(self) -> None:
        from linalg_tpu_torch.models.gpt import GPTConfig
        from linalg_tpu_torch.serve.engine import Request, ServeEngine

        shape, mix = self.shape, self.mix
        if self.device.type == "cuda":
            # the engine's host path is one Python thread; a pool of CPU
            # threads only contends with it for the host's shared cores
            torch.set_num_threads(1)
        cfg = GPTConfig(**{k: shape[k] for k in (
            "vocab_size", "d_model", "n_heads", "n_layers", "d_ff",
            "ctx_len", "pos", "dtype", "n_kv_heads", "window", "ffn")
            if k in shape})
        self.Request = Request
        params = weights.make_params(shape, self.init, self.seed,
                                     self.device, torch.bfloat16)
        self.eng = ServeEngine(params, cfg, device=self.device,
                               seed=self.seed % (1 << 62), **mix["engine"])
        del params
        self.traffic = Traffic(mix, shape["vocab_size"], self.seed)
        # warm: the longest prompt (every prefill shape) and a decode chunk
        warm = self.traffic.rng.integers(0, shape["vocab_size"],
                                         int(mix["prompt"]["max"]))
        self.eng.submit(Request(warm.tolist(), self.chunk, temperature=0.0,
                                top_k=1))
        self.eng.run()
        self.seen = len(self.eng.completions)
        # the first wave fills every slot, its outputs spread out
        spread = np.linspace(FIRST_WAVE_MIN, mix["output"]["max"],
                             int(mix["clients"])).round().astype(int)
        for out_len in self.traffic.rng.permutation(spread):
            self._send(time.perf_counter(), int(out_len))
        self._step()
        self._sync()

    def _send(self, now: float, out_len: int = 0) -> None:
        prompt, n = self.traffic.next(out_len)
        rid = self.eng.submit(self.Request(prompt, n, temperature=0.0,
                                           top_k=1))
        self.reqs[rid] = {"prompt": prompt, "n": n, "sent": now,
                          "first": None, "last": None, "got": 0}
        self.order.append(rid)

    def _step(self, span: bool = False) -> Dict:
        """One engine step, then the host's account of it: who got a first
        token, how many tokens arrived, who finished (and, while sending,
        each finished client's next request). ``span`` names both parts
        for the profiler."""
        fresh_from = self.admitted
        with _span("engine.step", span):
            self.eng.step()
        with _span("portbench.account", span):
            return self._account(fresh_from)

    def _account(self, fresh_from: int) -> Dict:
        now = time.perf_counter()
        admitted = len(self.order) - self.eng.pending
        for rid in self.order[self.admitted:admitted]:
            self.reqs[rid]["first"] = now
            self.live.append(rid)
        self.admitted = admitted
        rec = {"t": now, "tokens": 0, "least_s": 0.0, "rows": 0,
               "admits": self.order[fresh_from:admitted]}
        self._least(rec)
        still = []
        for rid in self.live:
            r = self.reqs[rid]
            got = min(self.chunk, r["n"] - r["got"])
            r["got"] += got
            rec["tokens"] += got
            if r["got"] < r["n"]:
                still.append(rid)
            else:
                r["last"] = now
        self.live = still
        for c in self.eng.completions[self.seen:]:
            r = self.reqs[c.request_id]
            r["tokens"] = c.tokens
            if len(c.tokens) != r["got"]:
                r["mismatch"] = True
            if self.sending:
                self._send(now)
        self.seen = len(self.eng.completions)
        return rec

    def _least(self, rec: Dict) -> None:
        """The step's least time on the card, and the KV rows its paged
        calls read. Prefill: every admitted prompt, the weights read
        once. Decode: at each of the chunk's token steps, the weights once
        and every live slot's cache up to its position; the FLOPs and the
        least time count only tokens that are delivered, the rows every
        slot decoded (a slot decodes the whole chunk)."""
        shape, peak = self.shape, flops.PEAK_BF16_FLOPS
        plens = [len(self.reqs[rid]["prompt"]) for rid in rec["admits"]]
        if plens:
            f = sum(flops.prefill_flops(shape, p) for p in plens)
            b = self.w_bytes + sum(plens) * self.row_bytes
            rec["least_s"] += max(f / peak, b / flops.HBM_BYTES_PER_S)
        pos = np.array([len(self.reqs[r]["prompt"]) + self.reqs[r]["got"]
                        for r in self.live], np.int64)
        left = np.array([self.reqs[r]["n"] - self.reqs[r]["got"]
                         for r in self.live], np.int64)
        # token step j: every live slot reads pos + j + 1 rows; the slots
        # still delivering (left > j) count toward the least time
        ctx = pos[None, :] + np.arange(1, self.chunk + 1)[:, None]
        on = left[None, :] > np.arange(self.chunk)[:, None]
        rec["rows"] += int(ctx.sum())
        n_on = on.sum(1)
        rows_on = (ctx * on).sum(1)
        per_tok = flops.decode_token_flops(shape, 0)
        per_row = flops.decode_token_flops(shape, 1) - per_tok
        f = n_on * per_tok + rows_on * per_row
        b = self.w_bytes + rows_on * self.row_bytes
        least = np.maximum(f / peak, b / flops.HBM_BYTES_PER_S)
        rec["least_s"] += float(least[n_on > 0].sum())

    def segment(self) -> Dict:
        n = TRACE_STEPS
        recs = [self._step(span=True) for _ in range(n)]
        L = self.shape["n_layers"]
        qo = flops.paged_call_bytes(self.shape, 0,
                                    self.mix["engine"]["n_slots"])
        rows = sum(r["rows"] for r in recs)
        paged_bytes = L * (rows * flops.kv_row_bytes(self.shape)
                           + self.chunk * n * qo)
        return {"steps": n, "token_steps": n * self.chunk,
                "paged_least_s": paged_bytes / flops.HBM_BYTES_PER_S}

    def measure(self, seconds: float) -> Dict:
        t0 = time.perf_counter()
        n0 = len(self.order)
        win: List[Dict] = []
        while True:
            rec = self._step()
            win.append(rec)
            if rec["t"] - t0 >= seconds:
                break
        t1 = win[-1]["t"]
        self.sending = False
        sent = [rid for rid in self.order[n0:]
                if self.reqs[rid]["sent"] < t1]
        while (any(self.reqs[r]["first"] is None for r in sent)
               and time.perf_counter() - t1 < LATE_S):
            self._step()
        dt = t1 - t0
        ttft = [self.reqs[r]["first"] - self.reqs[r]["sent"] for r in sent
                if self.reqs[r]["first"] is not None]
        done = [r for r in self.reqs.values()
                if r["last"] is not None and t0 < r["last"] <= t1
                and r["n"] > 1]
        tpot = [(r["last"] - r["first"]) / (r["n"] - 1) for r in done]
        tokens = sum(r["tokens"] for r in win)
        metrics = {"serve_tok_s": tokens / dt}
        if ttft:
            metrics["ttft_p95_ms"] = 1e3 * float(np.percentile(ttft, 95))
        if tpot:
            metrics["tpot_p95_ms"] = 1e3 * float(np.percentile(tpot, 95))
        return {"attempted": len(sent), "failed": len(sent) - len(ttft),
                "seconds": dt, "steps": len(win),
                "least_s": sum(r["least_s"] for r in win),
                "metrics": metrics}

    def release(self) -> None:
        self.__dict__.pop("eng", None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------

    def sample(self) -> List[Dict]:
        """The finished requests the check reads: the longest, and the
        rest drawn from the seed."""
        done = [self.reqs[r] for r in self.order if "tokens" in self.reqs[r]]
        if not done:  # nothing finished: nothing to judge, not correct
            return []
        k = int(self.cell["spec"]["check"]["requests"])
        longest = max(range(len(done)), key=lambda i: len(
            done[i]["prompt"]) + len(done[i]["tokens"]))
        rest = [i for i in range(len(done)) if i != longest]
        rng = np.random.default_rng([self.seed, 29])
        pick = rng.choice(len(rest), min(k - 1, len(rest)), replace=False)
        return [done[longest]] + [done[rest[i]] for i in sorted(pick)]

    def reference_gaps(self, reqs: List[Dict], control: bool = False
                       ) -> Dict:
        """Run the plain reference once over each prompt and its served
        tokens: ``program``, how far each served token's logit lies below
        the reference's best (None where a request came back short or
        mismatched); with ``control``, ``control``, the same for the
        tokens that the reference in float8 puts first."""
        p = weights.make_params(self.shape, self.init, self.seed,
                                self.device, torch.bfloat16)
        p = {"tok_W": p["tok_W"].float(), "head_b": p["head_b"].float(),
             **({"pos_W": p["pos_W"].float()} if "pos_W" in p else {}),
             "layers": {k: t.float() for k, t in p["layers"].items()}}
        gaps, cgaps, bad = [], [], 0
        with torch.no_grad(), ref.full_precision():
            for r in reqs:
                toks = list(r["tokens"])
                if len(toks) != r["n"] or r.get("mismatch"):
                    bad += 1
                    continue
                ids = torch.tensor(r["prompt"] + toks[:-1],
                                   device=self.device)
                P = len(r["prompt"])
                z = ref.logits(p, ref.hidden(p, ids, self.shape)[P - 1:])
                served = torch.tensor(toks, device=self.device)
                best = z.max(-1).values
                gaps.append(best - z.gather(-1, served[:, None])[:, 0])
                if control:
                    hc = ref.hidden(p, ids, self.shape, ref.fp8_mm)
                    pick = ref.logits(p, hc[P - 1:], ref.fp8_mm).argmax(-1)
                    cgaps.append(best - z.gather(-1, pick[:, None])[:, 0])
        del p
        out = {"program": torch.cat(gaps) if gaps and not bad else None,
               "tokens": sum(len(r["tokens"]) for r in reqs)}
        if control:
            out["control"] = torch.cat(cgaps) if cgaps else None
        return out

    def compared(self, gaps) -> Dict[str, Dict[str, float]]:
        """A stream's gaps scored against the cell's limit."""
        limit = self.cell["spec"]["limits"]["flip_gap"]
        return {"flip_gap": {"value": flip_gap(gaps), "limit": limit}}

    def check(self) -> Dict[str, Dict[str, float]]:
        return self.compared(self.reference_gaps(self.sample())["program"])
