"""LLM graph units, riding the graph walker (``graph/walker.py``):

* :class:`CascadeRouter`: the cheap tier answers first; the confidence
  signal its generative unit computes on the device (the mean top-2 logit
  margin, fetched with the tokens) decides escalation to the next tier,
  gated by the request's remaining deadline budget.
* :class:`Guardrail`: pre/post policy stages declared in the spec: regex
  block, PII scrub, length and stop-token policy, a classifier hook.

The embeddings path lives on the generative unit itself
(``GenerativeComponent.embed_rows``).
"""

from seldon_core_tpu_torch.graphllm.cascade import CascadeRouter  # noqa: F401
from seldon_core_tpu_torch.graphllm.guardrail import Guardrail  # noqa: F401

__all__ = ["CascadeRouter", "Guardrail"]
