"""LLM serving metrics: TTFT, ITL, E2EL, throughput (the port's own copy
of the reference's ``serving/metrics.py`` request accounting).

Timestamps are injected (``clock``) so tests can run against a virtual
clock.  The hand-off and registry parts of the reference are not ported
yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

STATUS_ACTIVE = "active"
STATUS_FINISHED = "finished"
STATUS_REJECTED = "rejected"


@dataclasses.dataclass
class RequestMetrics:
    request_id: str
    arrival: float
    n_prompt: int = 0
    prefill_start: Optional[float] = None
    first_token: Optional[float] = None
    finish: Optional[float] = None
    status: str = STATUS_ACTIVE
    n_cached: int = 0       # prompt tokens served from the prefix cache
    n_preempted: int = 0    # times this request was preempted + requeued
    token_times: List[float] = dataclasses.field(default_factory=list)
    # preemption timeline: preempt_times[i] pairs with resume_times[i]
    # (the next prefill_start); a trailing unpaired preempt_time is a
    # request that never got re-admitted
    preempt_times: List[float] = dataclasses.field(default_factory=list)
    resume_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def ttft(self) -> Optional[float]:
        return (self.first_token - self.arrival
                if self.first_token is not None else None)

    @property
    def e2el(self) -> Optional[float]:
        return self.finish - self.arrival if self.finish is not None else None

    @property
    def itl(self) -> List[float]:
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]

    @property
    def n_generated(self) -> int:
        return len(self.token_times)

    @property
    def resume_delays(self) -> List[float]:
        """Per-preemption time-to-resume (preempt -> next admission)."""
        return [b - a for a, b in zip(self.preempt_times,
                                      self.resume_times)]


class MetricsCollector:
    def __init__(self):
        self.requests: Dict[str, RequestMetrics] = {}
        # speculative-decoding counters, aggregated per engine: one row
        # is one decode slot in one verify launch
        self.spec_rows = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0

    def arrival(self, rid: str, t: float, n_prompt: int):
        self.requests[rid] = RequestMetrics(rid, t, n_prompt)

    def prefill_start(self, rid: str, t: float):
        r = self.requests[rid]
        r.prefill_start = t
        if len(r.preempt_times) > len(r.resume_times):
            # re-admission after preemption: close the preempt interval
            r.resume_times.append(t)

    def prefix_hit(self, rid: str, n_cached: int):
        """Record that ``n_cached`` prompt tokens were reused from the
        prefix cache (prefill compute the engine did NOT spend).  Clamped
        to the originally submitted prompt length: a preemption-resumed
        request re-prefills its own generated tokens via the cache, and
        counting those would push prefix_hit_rate past 1.0."""
        r = self.requests[rid]
        r.n_cached = max(r.n_cached, min(n_cached, r.n_prompt))

    def token(self, rid: str, t: float):
        r = self.requests[rid]
        if r.first_token is None:
            r.first_token = t
        r.token_times.append(t)

    def finish(self, rid: str, t: float):
        r = self.requests[rid]
        r.finish = t
        r.status = STATUS_FINISHED

    def preempt(self, rid: str, t: float):
        """The paged scheduler reclaimed this request's KV blocks and
        returned it to the queue (it resumes by re-prefilling its prompt
        plus already-generated tokens — usually a prefix-cache hit).
        ``t`` timestamps the preemption; the next ``prefill_start`` for
        this rid closes the interval, and ``summary()`` reports the
        mean time-to-resume."""
        r = self.requests[rid]
        r.n_preempted += 1
        r.preempt_times.append(t)

    def speculative(self, n_drafted: int, n_accepted: int,
                    n_emitted: int):
        """One decode slot went through one speculative verify launch:
        ``n_drafted`` tokens proposed, ``n_accepted`` of them accepted,
        ``n_emitted`` actually emitted -- normally ``n_accepted + 1`` (the
        correction or bonus token rides along), fewer when EOS or the
        generation budget cuts the burst."""
        self.spec_rows += 1
        self.spec_drafted += n_drafted
        self.spec_accepted += n_accepted
        self.spec_emitted += n_emitted

    def reject(self, rid: str, t: float):
        """The request was refused admission (e.g. prompt + generation
        budget exceeds slot capacity) — it never prefilled and must not
        pollute latency quantiles."""
        r = self.requests[rid]
        r.finish = t
        r.status = STATUS_REJECTED

    @staticmethod
    def _pct(xs, q):
        return float(np.percentile(xs, q)) if xs else float("nan")

    def summary(self) -> Dict[str, float]:
        vals = self.requests.values()
        done = [r for r in vals if r.status == STATUS_FINISHED]
        rejected = [r for r in vals if r.status == STATUS_REJECTED]
        ttfts = [r.ttft for r in done if r.ttft is not None]
        ttfts_hit = [r.ttft for r in done
                     if r.ttft is not None and r.n_cached > 0]
        ttfts_miss = [r.ttft for r in done
                      if r.ttft is not None and r.n_cached == 0]
        itls = [x for r in done for x in r.itl]
        e2els = [r.e2el for r in done if r.e2el is not None]
        gen = sum(r.n_generated for r in done)
        prompt_tokens = sum(r.n_prompt for r in done)
        saved = sum(r.n_cached for r in done)
        span = (max(r.finish for r in done) - min(r.arrival for r in done)
                if done else float("nan"))
        resumes = [d for r in vals for d in r.resume_delays]
        return {
            "completed": len(done),
            "rejected": len(rejected),
            "preempted": sum(r.n_preempted for r in vals),
            "preempt_to_resume_mean_s": (float(np.mean(resumes))
                                         if resumes else float("nan")),
            "qps": len(done) / span if done and span > 0 else float("nan"),
            "ttft_p50_s": self._pct(ttfts, 50),
            "ttft_p99_s": self._pct(ttfts, 99),
            "ttft_cached_p50_s": self._pct(ttfts_hit, 50),
            "ttft_uncached_p50_s": self._pct(ttfts_miss, 50),
            "itl_mean_s": float(np.mean(itls)) if itls else float("nan"),
            "itl_p99_s": self._pct(itls, 99),
            "e2el_mean_s": float(np.mean(e2els)) if e2els else float("nan"),
            "generated_tokens": gen,
            "prompt_tokens": prompt_tokens,
            "prefill_tokens_saved": saved,
            "prefix_hit_rate": (saved / prompt_tokens
                                if prompt_tokens else 0.0),
            "tokens_per_s": gen / span if done and span > 0 else float("nan"),
            "spec_acceptance_rate": (self.spec_accepted / self.spec_drafted
                                     if self.spec_drafted else float("nan")),
            "spec_tokens_per_launch": (self.spec_emitted / self.spec_rows
                                       if self.spec_rows else float("nan")),
        }
