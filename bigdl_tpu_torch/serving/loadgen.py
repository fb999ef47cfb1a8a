"""Poisson open-loop load generation with exact outcome accounting
(``bigdl_tpu/serving/loadgen.py``).

Open loop is the load model that exposes overload: arrivals come on their
own clock (exponential inter-arrival gaps) and never wait for completions,
so a server that slows down faces a growing queue instead of a client that
throttles itself.  Every submission lands in exactly one bucket
(``completed`` / ``shed`` / ``rejected`` / ``quarantined``), and the record
carries the identity residual (``unaccounted``).

The JAX package's burst-arrival injector (``bigdl.chaos.burstArrivals``)
waits for the port of its chaos hooks.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.serving.engine import OUTCOMES, Overloaded


def run_open_loop(engine, payloads: Sequence[Any],
                  rate_hz: float, deadline_ms: Optional[float] = None,
                  seed: int = 0,
                  on_arrival: Optional[Callable[[int], None]] = None,
                  result_timeout_s: float = 30.0) -> Dict[str, Any]:
    """Drive a ``ServingEngine`` with one Poisson open-loop pass over
    ``payloads``.

    ``rate_hz``: mean arrival rate (0 = back-to-back, the pure burst).
    ``on_arrival(i)`` runs before arrival ``i`` is submitted.  Returns the
    accounting record::

        {submitted, completed, shed, rejected, quarantined, unaccounted,
         latency_ms: [...], reject_latency_ms: [...],
         results: {arrival_key: np.ndarray},
         errors: {arrival_key: Exception},
         handles: [(arrival_key, RequestHandle | None)]}

    ``arrival_key`` is ``str(i)``.
    """
    rng = np.random.default_rng(seed)
    handles: List = []
    reject_latency_ms: List[float] = []
    errors: Dict[str, BaseException] = {}
    submitted = 0
    next_due = time.monotonic()

    def _arrive(key: str, payload) -> None:
        nonlocal submitted
        submitted += 1
        t0 = time.monotonic()
        try:
            h = engine.submit(payload, deadline_ms=deadline_ms)
        except Overloaded as e:
            # the reject path must be FAST — its latency is a headline
            # claim of the bench leg
            reject_latency_ms.append((time.monotonic() - t0) * 1e3)
            errors[key] = e
            handles.append((key, None))
        else:
            handles.append((key, h))

    for i, payload in enumerate(payloads):
        if on_arrival is not None:
            on_arrival(i)
        now = time.monotonic()
        if now < next_due:
            time.sleep(next_due - now)
        _arrive(str(i), payload)
        if rate_hz > 0:
            next_due = max(next_due, now) + float(
                rng.exponential(1.0 / rate_hz))

    # quiesce: every admitted request must reach its one terminal state
    results: Dict[str, Any] = {}
    latency_ms: List[float] = []
    counts = dict.fromkeys(OUTCOMES, 0)
    for key, h in handles:
        if h is None:
            counts["rejected"] += 1
            continue
        try:
            results[key] = h.result(timeout=result_timeout_s)
        except TimeoutError:
            pass            # stays unaccounted — the identity will flag it
        except Exception as e:  # terminal serving error
            errors[key] = e
        if h.outcome in counts:
            counts[h.outcome] += 1
        if h.outcome == "completed":
            latency_ms.append(h.latency_ms())

    record: Dict[str, Any] = {"submitted": submitted, **counts}
    record["unaccounted"] = submitted - sum(counts[o] for o in OUTCOMES)
    record["latency_ms"] = latency_ms
    record["reject_latency_ms"] = reject_latency_ms
    record["results"] = results
    record["errors"] = errors
    record["handles"] = handles
    return record


# ---------------------------------------------------------------------------
# LM token serving (bigdl_tpu_torch/serving/lm.py)
# ---------------------------------------------------------------------------


def sample_lm_workload(n: int, vocab_size: int, seed: int = 0,
                       prompt_lens: Sequence[int] = (8, 16, 32, 64),
                       output_lens: Sequence[int] = (4, 8, 16),
                       prompt_weights: Optional[Sequence[float]] = None,
                       output_weights: Optional[Sequence[float]] = None
                       ) -> List[Any]:
    """``n`` LM requests sampled from a prompt/output-length
    distribution: a list of ``(prompt_tokens, max_new_tokens)`` pairs
    (token ids 1-based, as the models expect).  Mixed lengths are the
    point — serving heterogeneous sequences through ONE fixed decode
    shape is what the paged cache buys."""
    rng = np.random.default_rng(seed)
    p_lens = np.asarray(list(prompt_lens), int)
    o_lens = np.asarray(list(output_lens), int)
    reqs = []
    for _ in range(n):
        p = int(rng.choice(p_lens, p=prompt_weights))
        o = int(rng.choice(o_lens, p=output_weights))
        prompt = rng.integers(1, vocab_size + 1, size=p).astype(np.int32)
        reqs.append((prompt, o))
    return reqs


def run_lm_open_loop(engine, requests: Sequence[Any], rate_hz: float,
                     deadline_ms: Optional[float] = None, seed: int = 0,
                     on_arrival: Optional[Callable[[int], None]] = None,
                     result_timeout_s: float = 60.0) -> Dict[str, Any]:
    """Poisson open-loop pass over ``(prompt, max_new_tokens)``
    requests against an ``LMServingEngine``, with per-request streaming
    consumption: every admitted stream gets a consumer thread iterating
    its :class:`~bigdl_tpu_torch.serving.lm.TokenStream` (recording TTFT and
    inter-token gaps client-side, on ARRIVAL of each token), so the
    record's percentiles measure the streamed experience, not just the
    terminal state.  Same arrival process and accounting identity as
    :func:`run_open_loop`.  Returns::

        {submitted, completed, shed, rejected, quarantined, unaccounted,
         tokens_total, elapsed_s, tokens_per_s,
         ttft_ms: [...], itl_ms: [...], latency_ms: [...],
         p50_ttft_ms, p99_ttft_ms, p50_itl_ms, p99_itl_ms,
         errors: {arrival_key: Exception},
         streams: [(arrival_key, TokenStream | None)]}
    """
    rng = np.random.default_rng(seed)
    streams: List = []
    consumers: List[threading.Thread] = []
    token_ns: Dict[str, List[int]] = {}
    reject_latency_ms: List[float] = []
    errors: Dict[str, BaseException] = {}
    submitted = 0
    t_start = time.monotonic()
    next_due = t_start

    def _consume(key: str, stream) -> None:
        arrivals = token_ns.setdefault(key, [])
        try:
            for _ in stream:
                arrivals.append(time.monotonic_ns())
        except Exception as e:  # terminal serving error, kept for record
            errors[key] = e

    def _arrive(key: str, prompt, max_new: int) -> None:
        nonlocal submitted
        submitted += 1
        t0 = time.monotonic()
        try:
            s = engine.submit(prompt, max_new_tokens=max_new,
                              deadline_ms=deadline_ms)
        except Overloaded as e:
            reject_latency_ms.append((time.monotonic() - t0) * 1e3)
            errors[key] = e
            streams.append((key, None))
        else:
            streams.append((key, s))
            t = threading.Thread(target=_consume, args=(key, s),
                                 daemon=True,
                                 name=f"lm-loadgen-consume-{key}")
            t.start()
            consumers.append(t)

    for i, (prompt, max_new) in enumerate(requests):
        if on_arrival is not None:
            on_arrival(i)
        now = time.monotonic()
        if now < next_due:
            time.sleep(next_due - now)
        _arrive(str(i), prompt, max_new)
        if rate_hz > 0:
            next_due = max(next_due, now) + float(
                rng.exponential(1.0 / rate_hz))

    # quiesce: every admitted stream must reach its one terminal state
    counts = dict.fromkeys(OUTCOMES, 0)
    latency_ms: List[float] = []
    ttft_ms: List[float] = []
    itl_ms: List[float] = []
    tokens_total = 0
    for key, s in streams:
        if s is None:
            counts["rejected"] += 1
            continue
        try:
            s.result(timeout=result_timeout_s)
        except TimeoutError:
            pass            # stays unaccounted — the identity flags it
        except Exception as e:
            errors[key] = e
        if s.outcome in counts:
            counts[s.outcome] += 1
        if s.outcome == "completed":
            latency_ms.append(s.latency_ms())
    for t in consumers:
        t.join(timeout=result_timeout_s)
    elapsed_s = time.monotonic() - t_start
    submit_ns = {key: s.submit_ns for key, s in streams if s is not None}
    for key, arrivals in token_ns.items():
        tokens_total += len(arrivals)
        if not arrivals:
            continue
        # client-side TTFT: the stream's submit clock and the arrival
        # clock are both time.monotonic_ns
        ttft_ms.append((arrivals[0] - submit_ns[key]) / 1e6)
        for a, b in zip(arrivals, arrivals[1:]):
            itl_ms.append((b - a) / 1e6)

    def _pct(xs: List[float], q: float) -> Optional[float]:
        return float(np.percentile(xs, q)) if xs else None

    record: Dict[str, Any] = {"submitted": submitted, **counts}
    record["unaccounted"] = submitted - sum(counts[o] for o in OUTCOMES)
    record["tokens_total"] = tokens_total
    record["elapsed_s"] = elapsed_s
    record["tokens_per_s"] = (tokens_total / elapsed_s
                              if elapsed_s > 0 else 0.0)
    record["ttft_ms"] = ttft_ms
    record["itl_ms"] = itl_ms
    record["latency_ms"] = latency_ms
    record["reject_latency_ms"] = reject_latency_ms
    record["p50_ttft_ms"] = _pct(ttft_ms, 50)
    record["p99_ttft_ms"] = _pct(ttft_ms, 99)
    record["p50_itl_ms"] = _pct(itl_ms, 50)
    record["p99_itl_ms"] = _pct(itl_ms, 99)
    record["errors"] = errors
    record["streams"] = streams
    return record
