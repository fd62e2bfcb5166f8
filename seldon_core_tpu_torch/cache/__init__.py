"""The caching and reuse plane: the content-addressed response cache
(``cache/content.py``: the engine tier and the walker's node tier),
request collapsing (``cache/singleflight.py``), the semantic tier over
pooled prompt embeddings (``cache/semantic.py``), and the generative
path's KV prefix index and its DRAM tier (``cache/prefix.py``,
``cache/tiers.py``, which also holds the suspend store of preempted and
drained generations).  Response-tier hits are served before QoS admission:
they take no admission slot, no queue position and no device step."""

from seldon_core_tpu_torch.cache.content import (  # noqa: F401
    ResponseCache,
    cache_deployments,
    cache_enabled,
    canonical_body,
    payload_cache_key,
    request_key,
    response_cache_from_env,
    spec_hash,
)
from seldon_core_tpu_torch.cache.semantic import (  # noqa: F401
    SemanticCache,
    semantic_cache_from_env,
    semantic_tag,
    semcache_enabled,
)
from seldon_core_tpu_torch.cache.singleflight import SingleFlight  # noqa: F401
