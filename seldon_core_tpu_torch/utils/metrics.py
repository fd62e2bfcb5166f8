"""Prometheus metrics on the stdlib: the port's copy of the JAX package's
``utils/metrics.py``, with no ``prometheus_client``.

The registry declares the JAX package's metric families with the same
names, types, help, label names and histogram buckets, so dashboards
built on the JAX engine (and the reference's ``seldon_api_engine_*``
names) read the port unchanged.  Each family holds labelled children
(``family.labels(*values)``); a family without labels is its own child.
Every update takes the child's lock: the scheduler's worker threads and
the event loop write the same families.

:meth:`MetricsRegistry.expose` renders the text format 0.0.4, or
OpenMetrics 1.0 with trace-id exemplars on the histograms observed
through :func:`observe_exemplar` when ``SCT_METRICS_EXEMPLARS`` is on.
Unlike ``prometheus_client`` it writes no ``_created`` samples.
``DEFAULT`` is the process's registry; ``MetricsRegistry()`` builds a
fresh one (the tests' use).
"""

from __future__ import annotations

import math
import os
import threading
import time
from contextlib import contextmanager

_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

OPENMETRICS_CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"
PLAIN_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_FALSY = ("", "0", "false", "off", "no")


def exemplars_enabled() -> bool:
    return os.environ.get("SCT_METRICS_EXEMPLARS", "0").strip().lower() not in _FALSY


def observe_exemplar(hist, value: float, trace_id: str | None) -> None:
    """Observe ``value``, with an exemplar naming ``trace_id`` (a link to
    ``GET /stats/timeline?trace=``) when exemplars are on."""
    if trace_id and exemplars_enabled():
        hist.observe(value, exemplar={"trace_id": trace_id})
    else:
        hist.observe(value)


def _go_float(d: float) -> str:
    """A float as Prometheus (Go) writes it: ``+Inf``, ``NaN``, ``1e+06``."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _labelstr(pairs) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in sorted(pairs)) + "}"


COUNTER, GAUGE, HISTOGRAM = "counter", "gauge", "histogram"


class _Child:
    """One labelled series of a family."""

    __slots__ = ("_kind", "_lock", "_value", "_fn", "_bounds", "_buckets", "_sum",
                 "_exemplars")

    def __init__(self, kind: str, bounds: tuple[float, ...] | None):
        self._kind = kind
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = None
        self._bounds = bounds
        if kind == HISTOGRAM:
            self._buckets = [0.0] * len(bounds)
            self._sum = 0.0
            self._exemplars: dict[int, tuple] = {}

    # counter and gauge
    def inc(self, amount: float = 1.0) -> None:
        if self._kind == COUNTER and amount < 0:
            raise ValueError("counters can only be incremented by non-negative amounts")
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def set_function(self, fn) -> None:
        """A gauge read from ``fn()`` at exposition time."""
        self._fn = fn

    def get(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._value

    # histogram
    def observe(self, amount: float, exemplar: dict | None = None) -> None:
        amount = float(amount)
        with self._lock:
            self._sum += amount
            for i, b in enumerate(self._bounds):
                if amount <= b:
                    self._buckets[i] += 1
                    if exemplar:
                        self._exemplars[i] = (dict(exemplar), amount, time.time())
                    break

    def snapshot(self) -> tuple[list[float], float, dict]:
        """``(per-bucket counts, sum, exemplars by bucket)`` for a histogram."""
        with self._lock:
            return list(self._buckets), self._sum, dict(self._exemplars)


class Family:
    """A metric family: a name, a type, its help and its label names."""

    def __init__(self, kind: str, name: str, documentation: str,
                 labelnames: tuple[str, ...] = (), buckets: tuple[float, ...] | None = None):
        if kind == COUNTER and name.endswith("_total"):
            name = name[:-len("_total")]  # as prometheus_client names the family
        self.kind = kind
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self.bounds = None
        if kind == HISTOGRAM:
            b = tuple(float(x) for x in (buckets or _BUCKETS))
            self.bounds = b if b[-1] == math.inf else b + (math.inf,)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], _Child] = {}
        if not self.labelnames:
            self._children[()] = _Child(kind, self.bounds)

    def labels(self, *values, **kv) -> _Child:
        if kv:
            values = tuple(kv[n] for n in self.labelnames)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels {self.labelnames}, got {values}")
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, _Child(self.kind, self.bounds))
        return child

    def clear(self) -> None:
        with self._lock:
            self._children.clear()

    # a family without labels is its own series
    def inc(self, amount: float = 1.0) -> None:
        self._children[()].inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._children[()].dec(amount)

    def set(self, value: float) -> None:
        self._children[()].set(value)

    def set_function(self, fn) -> None:
        self._children[()].set_function(fn)

    def observe(self, amount: float, exemplar: dict | None = None) -> None:
        self._children[()].observe(amount, exemplar)

    def samples(self, openmetrics: bool = False):
        """``(sample name, label pairs, value, exemplar)`` tuples."""
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            pairs = list(zip(self.labelnames, key))
            if self.kind == COUNTER:
                yield f"{self.name}_total", pairs, child.get(), None
            elif self.kind == GAUGE:
                yield self.name, pairs, child.get(), None
            else:
                counts, total, exemplars = child.snapshot()
                acc = 0.0
                for i, (b, n) in enumerate(zip(self.bounds, counts)):
                    acc += n
                    yield (f"{self.name}_bucket", pairs + [("le", _go_float(b))], acc,
                           exemplars.get(i) if openmetrics else None)
                yield f"{self.name}_count", pairs, acc, None
                yield f"{self.name}_sum", pairs, total, None


# the JAX package's families, in its order: (attribute, type, name, help,
# label names[, histogram buckets])
FAMILIES: tuple[tuple, ...] = (
    ("server_requests", HISTOGRAM, "seldon_api_engine_server_requests_duration_seconds",
     'Engine ingress request latency',
     ('deployment_name', 'predictor_name', 'service', 'method', 'code'), _BUCKETS),
    ("client_requests", HISTOGRAM, "seldon_api_engine_client_requests_duration_seconds",
     'Per-graph-node downstream call latency',
     ('deployment_name', 'predictor_name', 'model_name', 'model_image', 'model_version',
      'method', 'code'), _BUCKETS),
    ("ingress_requests", HISTOGRAM, "seldon_api_ingress_server_requests_duration_seconds",
     'Gateway ingress request latency',
     ('principal', 'deployment_name', 'service', 'method', 'code'), _BUCKETS),
    ("feedback", COUNTER, "seldon_api_model_feedback",
     'Feedback events per unit',
     ('deployment_name', 'predictor_name', 'model_name')),
    ("feedback_reward", COUNTER, "seldon_api_model_feedback_reward",
     'Accumulated reward per unit',
     ('deployment_name', 'predictor_name', 'model_name')),
    ("custom_counter", COUNTER, "seldon_model_custom_counter",
     'User-code emitted counter metrics (Meta.metrics extension)',
     ('deployment_name', 'predictor_name', 'model_name', 'key')),
    ("custom_gauge", GAUGE, "seldon_model_custom_gauge",
     'User-code emitted gauge metrics',
     ('deployment_name', 'predictor_name', 'model_name', 'key')),
    ("custom_timer", HISTOGRAM, "seldon_model_custom_timer",
     'User-code emitted timer metrics (seconds)',
     ('deployment_name', 'predictor_name', 'model_name', 'key'), _BUCKETS),
    ("batch_size", HISTOGRAM, "seldon_executor_batch_size",
     'Continuous-batching effective batch sizes',
     ('model_name',), (1, 2, 4, 8, 16, 32, 64, 128, 256)),
    ("queue_depth", GAUGE, "seldon_executor_queue_depth",
     'Continuous-batching queue depth',
     ('model_name',)),
    ("queue_wait", HISTOGRAM, "seldon_executor_queue_wait_seconds",
     'Time a request waited in the batching queue before its device step',
     ('model_name',), _BUCKETS),
    ("device_step", HISTOGRAM, "seldon_executor_device_step_seconds",
     'Device step round-trip time (dispatch through result fetch)',
     ('model_name',), _BUCKETS),
    ("mfu", GAUGE, "seldon_executor_mfu",
     'Model FLOP/s utilization of the most recent device step (achieved/chip peak; '
     'absent off-TPU)',
     ('model_name',)),
    ("ttft", HISTOGRAM, "seldon_generative_ttft_seconds",
     'Generative time-to-first-token (submit to first sampled token)',
     ('model_name',), _BUCKETS),
    ("itl", HISTOGRAM, "seldon_itl_seconds",
     'Generative per-slot inter-token latency (delivery gap per fetched block over the'
     ' tokens it carried) — prefill-induced decode stalls land here, invisible to '
     'TTFT/device-step',
     ('model_name',), _BUCKETS),
    ("generated_tokens", COUNTER, "seldon_generative_tokens_total",
     'Generated tokens (rate() gives sustained tokens/s)',
     ('model_name',)),
    ("tokens_per_s", GAUGE, "seldon_generative_tokens_per_s",
     'Per-request decode rate of the most recently completed generation',
     ('model_name',)),
    ("qos_admitted", COUNTER, "seldon_qos_admitted_total",
     'Requests admitted past QoS admission control',
     ('name', 'priority')),
    ("qos_shed", COUNTER, "seldon_qos_shed_total",
     'Requests shed by QoS admission control, by reason',
     ('name', 'reason', 'priority')),
    ("qos_deadline_miss", COUNTER, "seldon_qos_deadline_miss_total",
     'Requests dropped by a queue because their deadline expired before a device step '
     'was spent on them',
     ('name', 'stage')),
    ("qos_inflight", GAUGE, "seldon_qos_inflight",
     'Requests currently admitted (running + queued) per deployment',
     ('name',)),
    ("qos_brownout", GAUGE, "seldon_qos_brownout",
     '1 while the deployment rides out sustained overload in brownout mode (batch '
     'shed, max_new_tokens clamped)',
     ('name',)),
    ("wire_bytes", COUNTER, "seldon_wire_bytes",
     'Bytes moved per transport edge (server edges: in=request, out=response; client '
     'edges: out=request sent, in=reply)',
     ('stage', 'name', 'direction')),
    ("wire_requests", COUNTER, "seldon_wire_requests",
     'Transfers per transport edge',
     ('stage', 'name')),
    ("wire_mb_s", GAUGE, "seldon_wire_mb_per_s",
     'Achieved wire MB/s EWMA per transport edge (per-transfer bytes/duration where '
     'the edge times the transfer)',
     ('stage', 'name')),
    ("eventloop_lag", GAUGE, "seldon_eventloop_lag_seconds",
     'Serving event-loop lag EWMA (scheduled-vs-actual callback delta; a saturated '
     'loop shows here first)',
     ('service',)),
    ("host_syncs", COUNTER, "seldon_executor_host_syncs",
     'Host<->device synchronization points (result materializations) — divide by '
     'device steps for syncs/step',
     ('model_name',)),
    ("device_frac", GAUGE, "seldon_executor_step_device_frac",
     'Fraction of the last device step spent waiting on the device (fetch) vs host-'
     'side dispatch work',
     ('model_name',)),
    ("cache_hits", COUNTER, "seldon_cache_hits",
     'Response-cache hits per tier (gateway/engine/node) and namespace',
     ('tier', 'name')),
    ("cache_misses", COUNTER, "seldon_cache_misses",
     'Response-cache misses per tier and namespace',
     ('tier', 'name')),
    ("cache_entries", GAUGE, "seldon_cache_entries",
     'Live response-cache entries per tier',
     ('tier',)),
    ("cache_bytes", GAUGE, "seldon_cache_bytes",
     'Bytes held by the response cache per tier',
     ('tier',)),
    ("cache_collapsed", COUNTER, "seldon_cache_collapsed",
     'Requests collapsed onto an identical in-flight computation (single-flight '
     'followers; leaders are regular requests)',
     ('name',)),
    ("prefix_tokens_reused", COUNTER, "seldon_cache_prefix_tokens_reused",
     'Prompt tokens whose prefill was skipped via KV prefix reuse',
     ('model_name',)),
    ("prefix_blocks", GAUGE, "seldon_cache_prefix_blocks",
     'KV pool blocks currently held by the prefix-reuse index',
     ('model_name',)),
    ("prefix_tier_hits", GAUGE, "seldon_prefix_tier_hits",
     'Prefix matches satisfied by this tier (hbm/dram/peer)',
     ('model_name', 'tier')),
    ("prefix_tier_promotions", GAUGE, "seldon_prefix_tier_promotions",
     'Chain levels promoted out of this tier into HBM (dram: fused promotion scatters;'
     ' peer: levels installed from pulls)',
     ('model_name', 'tier')),
    ("prefix_tier_demotions", GAUGE, "seldon_prefix_tier_demotions",
     'Chain levels demoted out of this tier (hbm: index evictions; dram levels '
     "absorbed ride the dram tier's own counter)",
     ('model_name', 'tier')),
    ("prefix_tier_bytes", GAUGE, "seldon_prefix_tier_bytes",
     'Bytes of prefix KV currently held by this tier',
     ('model_name', 'tier')),
    ("spec_emitted", COUNTER, "seldon_spec_emitted_tokens",
     'Tokens emitted by fused speculative verify passes',
     ('model_name',)),
    ("spec_verify_passes", COUNTER, "seldon_spec_verify_passes",
     'Per-slot speculative verify passes (active slot x fused step)',
     ('model_name',)),
    ("spec_accepted_per_step", GAUGE, "seldon_spec_accepted_tokens_per_step",
     'Cumulative tokens emitted per verify pass (speculative decode acceptance; 1.0 = '
     'no draft ever accepted)',
     ('model_name',)),
    ("spec_emitted_by_method", COUNTER, "seldon_spec_emitted_tokens_by_method",
     'Tokens emitted by fused speculative verify passes, split by proposer '
     '(spec_method)',
     ('model_name', 'spec_method')),
    ("spec_verify_passes_by_method", COUNTER, "seldon_spec_verify_passes_by_method",
     'Per-slot speculative verify passes, split by proposer (spec_method)',
     ('model_name', 'spec_method')),
    ("spec_accepted_per_step_by_method", GAUGE, "seldon_spec_accepted_tokens_per_step_by_method",
     'Cumulative tokens emitted per verify pass, split by proposer (spec_method)',
     ('model_name', 'spec_method')),
    ("cascade_requests", COUNTER, "seldon_cascade_requests",
     'Requests whose final answer came from this cascade tier (tier is the 0-based '
     'position in the ordered tier list)',
     ('name', 'tier')),
    ("cascade_escalations", COUNTER, "seldon_cascade_escalations",
     'Cascade escalations to the next tier, by reason (low-confidence)',
     ('name',)),
    ("cascade_confidence", GAUGE, "seldon_cascade_confidence",
     'Last observed cheap-tier confidence (mean top-2 logit margin) at this cascade '
     'router',
     ('name',)),
    ("semcache_hits", COUNTER, "seldon_semcache_hits",
     'Semantic cache-tier hits (cosine >= threshold) per namespace',
     ('name',)),
    ("semcache_misses", COUNTER, "seldon_semcache_misses",
     'Semantic cache-tier misses per namespace',
     ('name',)),
    ("semcache_entries", GAUGE, "seldon_semcache_entries",
     'Live semantic cache-tier entries',
     ()),
    ("semcache_bytes", GAUGE, "seldon_semcache_bytes",
     'Bytes held by the semantic cache tier (vectors + responses)',
     ()),
    ("guardrail_actions", COUNTER, "seldon_guardrail_actions",
     'Guardrail-unit outcomes (action: pass / scrub / truncate / stop / block) per '
     'unit name',
     ('name', 'action')),
    ("kv_slots_per_chip", GAUGE, "seldon_kv_slots_per_chip",
     'Max-seq sequences the paged-KV layout fits per chip after weights (int8 KV '
     'quantization ~doubles this)',
     ('model_name',)),
    ("kv_blocks", GAUGE, "seldon_kv_blocks",
     'Paged-KV pool blocks by holder (state: free / prefix_index / slots)',
     ('model_name', 'state')),
    ("kv_blocks_high_water", GAUGE, "seldon_kv_blocks_high_water",
     'High-water mark of paged-KV pool blocks in use since boot',
     ('model_name',)),
    ("kv_bytes", GAUGE, "seldon_kv_bytes",
     'HBM bytes by class (weights / kv_pool / kv_scales) for one generative unit',
     ('model_name', 'class')),
    ("kv_prefix_evictions", GAUGE, "seldon_kv_prefix_evictions",
     'Cumulative prefix-index entries evicted under pool pressure or flush',
     ('model_name',)),
    ("program_compiles", COUNTER, "seldon_program_compiles",
     'Fresh XLA program compiles in the generative program caches (warmup + serving; '
     'serving-time ones also record a program.compile span)',
     ('model_name',)),
    ("lora_resident", GAUGE, "seldon_lora_resident_adapters",
     'Named LoRA adapters resident in the stacked device pool',
     ('model_name',)),
    ("lora_evictions", GAUGE, "seldon_lora_evictions",
     'Cumulative LRU evictions from the adapter pool',
     ('model_name',)),
    ("lora_bytes", GAUGE, "seldon_lora_pool_bytes",
     'HBM bytes held by the stacked LoRA adapter pool (also the adapter_pool class of '
     'seldon_kv_bytes)',
     ('model_name',)),
    ("lora_tokens", COUNTER, "seldon_lora_tokens",
     'Generated tokens served per named adapter',
     ('model_name', 'adapter')),
    ("obs_spans", GAUGE, "seldon_obs_spans",
     'Span recorder counters (state: recorded / ring / sampled_out)',
     ('state',)),
    ("obs_export", GAUGE, "seldon_obs_span_export",
     'Span exporter totals across configured exporters (result: exported / dropped)',
     ('result',)),
    ("fleet_replicas", GAUGE, "seldon_fleet_replicas",
     'Replicas per deployment as the fleet collector sees them (status: live / stale)',
     ('deployment', 'status')),
    ("fleet_counter", GAUGE, "seldon_fleet_counter",
     'Fleet-summed QoS counters per deployment (admitted_total / shed_total / '
     'deadline_miss_total)',
     ('deployment', 'counter')),
    ("fleet_p99_ms", GAUGE, "seldon_fleet_p99_ms",
     'Histogram-merged fleet p99 per flight-recorder stage (ms)',
     ('deployment', 'stage')),
    ("slo_burn_rate", GAUGE, "seldon_slo_burn_rate",
     'SLO error-budget burn rate per objective and window (1.0 = burning exactly the '
     'budget)',
     ('deployment', 'objective', 'window')),
    ("slo_state", GAUGE, "seldon_slo_state",
     'SLO state per objective (0 ok, 1 warn, 2 page)',
     ('deployment', 'objective')),
    ("slo_transitions", COUNTER, "seldon_slo_transitions",
     'SLO state-machine transitions, labeled by the state entered',
     ('deployment', 'objective', 'to')),
    ("autoscale_target", GAUGE, "seldon_autoscale_target_replicas",
     'Latest per-pool replica target computed by the autoscale policy '
     '(docs/AUTOSCALING.md)',
     ('deployment', 'role')),
    ("autoscale_pressure", GAUGE, "seldon_autoscale_pressure",
     'Max signal pressure (smoothed value / declared target) driving the latest '
     'decision (1.0 = at target)',
     ('deployment',)),
    ("autoscale_decisions", COUNTER, "seldon_autoscale_decisions",
     'Autoscale decisions actuated, labeled by direction (up / down) and the policy '
     'reason',
     ('deployment', 'direction', 'reason')),
    ("autoscale_drains", COUNTER, "seldon_autoscale_drains",
     'Drain-based shrink outcomes (ok: victim migrated all streams; failed: shrink '
     'aborted, replica kept)',
     ('deployment', 'outcome')),
    ("usage_device_seconds", GAUGE, "seldon_usage_device_seconds",
     'Device-step seconds attributed per tenant (fused blocks split across occupied '
     'slots by token share)',
     ('deployment', 'adapter', 'qos')),
    ("usage_grant_seconds", GAUGE, "seldon_usage_grant_seconds",
     'Arbiter grant-interval wall seconds the deployment held the device',
     ('deployment', 'adapter', 'qos')),
    ("usage_tokens", GAUGE, "seldon_usage_tokens",
     'Tokens attributed per tenant by kind (prefill / decode / spec_accepted / '
     'saved_hbm / saved_dram / saved_peer / wasted)',
     ('deployment', 'adapter', 'qos', 'kind')),
    ("usage_requests", GAUGE, "seldon_usage_requests",
     'Requests attributed per tenant by outcome (completed / shed / reaped / cached)',
     ('deployment', 'adapter', 'qos', 'outcome')),
    ("usage_suspend_byte_seconds", GAUGE, "seldon_usage_suspend_byte_seconds",
     "Bytes x seconds a tenant's preempted KV sat parked in the host suspend store",
     ('deployment', 'adapter', 'qos')),
    ("usage_meter_keys", GAUGE, "seldon_usage_meter_keys",
     'Live usage-meter key rows (LRU-bounded by SCT_METER_MAX_KEYS)',
     ()),
    ("usage_meter_evicted", GAUGE, "seldon_usage_meter_evicted",
     'Key rows LRU-evicted into the `other` rollup since boot',
     ()),
)

# label sets exported per seldon_usage_* field group (refresh_usage)
_USAGE_TOKEN_KINDS = (
    ("prefill", "tokens_prefill"),
    ("decode", "tokens_decode"),
    ("spec_accepted", "tokens_spec_accepted"),
    ("spec_accepted_ngram", "tokens_spec_accepted_ngram"),
    ("spec_accepted_heads", "tokens_spec_accepted_heads"),
    ("spec_accepted_draft", "tokens_spec_accepted_draft"),
    ("saved_hbm", "tokens_saved_hbm"),
    ("saved_dram", "tokens_saved_dram"),
    ("saved_peer", "tokens_saved_peer"),
    ("wasted", "tokens_wasted"),
)
_USAGE_REQ_OUTCOMES = (
    ("completed", "requests_completed"),
    ("shed", "requests_shed"),
    ("reaped", "requests_reaped"),
    ("cached", "requests_cached"),
)


class MetricsRegistry:
    """The process's metric families (:data:`FAMILIES`), each an attribute
    under the JAX registry's name (``registry.ttft.labels(model)``)."""

    def __init__(self):
        self.families: list[Family] = []
        for attr, kind, name, doc, labelnames, *buckets in FAMILIES:
            fam = Family(kind, name, doc, labelnames, buckets[0] if buckets else None)
            setattr(self, attr, fam)
            self.families.append(fam)
        # per-adapter label values: the first SCT_METER_ADAPTER_LABELS
        # adapters keep their own, later ones report as `other`
        self._adapter_label_lock = threading.Lock()
        self._adapter_labels: dict[str, str] = {}
        self._adapter_label_max: int | None = None
        self.adapter_rollups = 0

    @contextmanager
    def time_server_request(self, deployment: str, predictor: str, service: str, method: str):
        """Time a request; the caller sets ``holder["code"]`` (default 200)."""
        holder = {"code": "200"}
        start = time.perf_counter()
        try:
            yield holder
        finally:
            self.server_requests.labels(deployment, predictor, service, method,
                                        holder["code"]).observe(time.perf_counter() - start)

    def record_custom(self, deployment: str, predictor: str, model: str, metrics) -> None:
        """A user model's ``meta.metrics``: GAUGE sets, TIMER (ms) observes
        seconds, anything else counts."""
        for m in metrics:
            if m.type == "GAUGE":
                self.custom_gauge.labels(deployment, predictor, model, m.key).set(m.value)
            elif m.type == "TIMER":
                self.custom_timer.labels(deployment, predictor, model, m.key).observe(
                    m.value / 1000.0)
            else:
                self.custom_counter.labels(deployment, predictor, model, m.key).inc(m.value)

    def adapter_label(self, adapter: str) -> str:
        """A bounded label value for per-adapter families; the null adapter
        passes through."""
        if not adapter:
            return adapter
        with self._adapter_label_lock:
            lbl = self._adapter_labels.get(adapter)
            if lbl is not None:
                return lbl
            if self._adapter_label_max is None:
                self._adapter_label_max = max(
                    0, int(os.environ.get("SCT_METER_ADAPTER_LABELS") or 32))
            if len(self._adapter_labels) < self._adapter_label_max:
                self._adapter_labels[adapter] = adapter
                return adapter
            self.adapter_rollups += 1
            return "other"

    def refresh_usage(self, meter=None) -> None:
        """Rebuild the ``seldon_usage_*`` gauges from the usage meter's
        top-K export (at scrape time), dropping rows that left the top K."""
        if meter is None:
            from seldon_core_tpu_torch.obs.metering import METER as meter
        if not meter.enabled:
            return
        rows = meter.export_rows()
        for fam in (self.usage_device_seconds, self.usage_grant_seconds, self.usage_tokens,
                    self.usage_requests, self.usage_suspend_byte_seconds):
            fam.clear()
        for (dep, adapter, qos), row in rows:
            self.usage_device_seconds.labels(dep, adapter, qos).set(row.get("device_s", 0.0))
            if "grant_s" in row:
                self.usage_grant_seconds.labels(dep, adapter, qos).set(row["grant_s"])
            for kind, field in _USAGE_TOKEN_KINDS:
                if field in row:
                    self.usage_tokens.labels(dep, adapter, qos, kind).set(row[field])
            for outcome, field in _USAGE_REQ_OUTCOMES:
                if field in row:
                    self.usage_requests.labels(dep, adapter, qos, outcome).set(row[field])
            if "suspend_byte_s" in row:
                self.usage_suspend_byte_seconds.labels(dep, adapter, qos).set(
                    row["suspend_byte_s"])
        self.usage_meter_keys.set(meter.size())
        self.usage_meter_evicted.set(meter.evicted)

    def expose(self, openmetrics: bool | None = None) -> bytes:
        """The ``/prometheus`` body: text 0.0.4, or OpenMetrics with
        exemplars when ``SCT_METRICS_EXEMPLARS`` is on."""
        if openmetrics is None:
            openmetrics = exemplars_enabled()
        out: list[str] = []
        for fam in self.families:
            doc = fam.documentation
            if openmetrics:
                head = fam.name
                doc = _escape_label(doc)
            else:
                head = f"{fam.name}_total" if fam.kind == COUNTER else fam.name
                doc = doc.replace("\\", r"\\").replace("\n", r"\n")
            out.append(f"# HELP {head} {doc}\n# TYPE {head} {fam.kind}\n")
            for name, pairs, value, ex in fam.samples(openmetrics):
                line = f"{name}{_labelstr(pairs)} {_go_float(value)}"
                if ex is not None:
                    labels, ex_value, ts = ex
                    line += f" # {_labelstr(labels.items())} {_go_float(ex_value)} {ts}"
                out.append(line + "\n")
        if openmetrics:
            out.append("# EOF\n")
        return "".join(out).encode()

    def expose_content_type(self) -> str:
        return OPENMETRICS_CONTENT_TYPE if exemplars_enabled() else PLAIN_CONTENT_TYPE


# the process-wide registry
DEFAULT = MetricsRegistry()
