"""Component contract and the built-in graph units the port serves.

A *component* is the object behind a graph node, duck-typed as in the JAX
package's ``graph/units.py``:

    predict(X, feature_names) -> ndarray          MODEL
    route(X, feature_names) -> int                ROUTER
    aggregate(Xs, features_list) -> ndarray       COMBINER
    transform_input(X, feature_names) -> ndarray  TRANSFORMER
    transform_output(X, feature_names) -> ndarray OUTPUT_TRANSFORMER
    send_feedback(X, feature_names, reward, truth, routing)  optional
    class_names: list[str]                        optional

with optional ``tags()`` / ``metrics()`` merged into the response meta.
Any method may be ``async def``, and the ``*_raw`` variants take and
return a :class:`Payload` for full control of meta and encoding.

The host-only built-ins (routers, the combiner, the outlier scorer) are
numpy, with the JAX units' ``default_rng(seed)``, so their decisions are
those of the JAX package under the same seed.  ``JAX_MODEL`` and
``JAX_GENERATIVE`` keep their names, so that a graph spec the JAX engine
serves is served unchanged; here they build the PyTorch zoo and
generative components.  ``CASCADE_ROUTER`` and
``GUARDRAIL`` come from ``graphllm/``, imported when first built.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from seldon_core_tpu_torch.graph.spec import Implementation


class GraphUnitError(Exception):
    """A unit rejected its input or its configuration (maps to Status
    FAILURE on the wire)."""


class SeldonComponent:
    """Optional convenience base class; duck typing is what matters."""

    def init_metadata(self) -> dict[str, Any]:
        return {}

    def tags(self) -> dict[str, Any]:
        return {}

    def metrics(self) -> list[dict[str, Any]]:
        return []


class SimpleModel(SeldonComponent):
    """Stub model returning a constant 3-class score row per input row."""

    INLINE_SYNC = True  # microseconds of python math; skip the executor hop
    # DETERMINISTIC marks a component whose output is a pure function of
    # its input.  Stateful (Mahalanobis), randomized (RandomABTest) and
    # feedback-driven (bandit routers) components must not carry it.
    DETERMINISTIC = True

    values = np.array([0.1, 0.9, 0.5])
    class_names = ["class0", "class1", "class2"]

    def predict(self, X: np.ndarray, names: list[str]) -> np.ndarray:
        rows = X.shape[0] if getattr(X, "ndim", 0) >= 2 else 1
        return np.tile(self.values, (rows, 1))


class SimpleRouter(SeldonComponent):
    """Always routes to child 0."""

    INLINE_SYNC = True
    DETERMINISTIC = True  # always child 0

    def route(self, X: np.ndarray, names: list[str]) -> int:
        return 0


class RandomABTest(SeldonComponent):
    """Routes to child 0 with probability ``ratioA``, else child 1; seeded
    for reproducibility."""

    INLINE_SYNC = True

    def __init__(self, ratioA: float = 0.5, seed: int = 1337, **_: Any):
        self.ratio_a = float(ratioA)
        self._rng = np.random.default_rng(seed)

    def route(self, X: np.ndarray, names: list[str]) -> int:
        return 0 if self._rng.random() < self.ratio_a else 1


class AverageCombiner(SeldonComponent):
    """Element-wise mean of the children's outputs, whose shapes must agree.
    Not inline: the copies scale with the children's payloads, which
    belongs on the thread pool, not the event loop."""

    DETERMINISTIC = True  # a pure element-wise mean

    def aggregate(self, Xs: list[np.ndarray], features: list[list[str]]) -> np.ndarray:
        if not Xs:
            raise GraphUnitError("AverageCombiner needs at least one input")
        arrs = [np.asarray(x, dtype=np.float64) for x in Xs]
        shape = arrs[0].shape
        for i, a in enumerate(arrs[1:], start=1):
            if a.shape != shape:
                raise GraphUnitError(
                    f"AverageCombiner shape mismatch: input 0 {shape} vs input {i} {a.shape}"
                )
        return np.mean(np.stack(arrs), axis=0)


class EpsilonGreedy(SeldonComponent):
    """Multi-armed-bandit router: explore with probability ``epsilon``,
    otherwise exploit the branch with the best mean reward; rewards arrive
    through the feedback walk."""

    INLINE_SYNC = True

    def __init__(self, n_branches: int = 2, epsilon: float = 0.1, seed: int | None = 1337,
                 **_: Any):
        if n_branches < 1:
            raise GraphUnitError("n_branches must be >= 1")
        self.n_branches = int(n_branches)
        self.epsilon = float(epsilon)
        self._rng = np.random.default_rng(seed)
        self.pulls = np.zeros(self.n_branches, dtype=np.int64)
        self.value = np.zeros(self.n_branches, dtype=np.float64)

    def route(self, X: np.ndarray, names: list[str]) -> int:
        if self._rng.random() < self.epsilon:
            return int(self._rng.integers(self.n_branches))
        return int(np.argmax(self.value))

    def send_feedback(self, X: np.ndarray, names: list[str], reward: float, truth: Any = None,
                      routing: int | None = None) -> None:
        if routing is None or not (0 <= routing < self.n_branches):
            return
        self.pulls[routing] += 1
        # incremental mean of the observed rewards per branch
        self.value[routing] += (reward - self.value[routing]) / self.pulls[routing]


class ThompsonSampling(SeldonComponent):
    """Beta-Bernoulli Thompson-sampling router: sample a win rate per
    branch, route to the largest."""

    INLINE_SYNC = True

    def __init__(self, n_branches: int = 2, seed: int | None = 1337, **_: Any):
        self.n_branches = int(n_branches)
        self._rng = np.random.default_rng(seed)
        self.alpha = np.ones(self.n_branches)
        self.beta = np.ones(self.n_branches)

    def route(self, X: np.ndarray, names: list[str]) -> int:
        return int(np.argmax(self._rng.beta(self.alpha, self.beta)))

    def send_feedback(self, X, names, reward, truth=None, routing=None) -> None:
        if routing is None or not (0 <= routing < self.n_branches):
            return
        if reward > 0:
            self.alpha[routing] += reward
        else:
            self.beta[routing] += 1.0


class MahalanobisOutlier(SeldonComponent):
    """Online Mahalanobis-distance outlier scorer: a running mean and
    covariance over the request stream (Welford), each row scored by its
    squared distance before it joins them; a TRANSFORMER that annotates
    ``meta.tags.outlier_score``."""

    def __init__(self, **_: Any):
        self.count = 0
        self._mean: np.ndarray | None = None
        self._m2: np.ndarray | None = None  # sum of outer-product deviations
        self._last_scores: np.ndarray | None = None

    def score(self, X: np.ndarray) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        d = X.shape[1]
        if self._mean is None:
            self._mean = np.zeros(d)
            self._m2 = np.zeros((d, d))
        scores = np.zeros(X.shape[0])
        for i, row in enumerate(X):
            if self.count >= 2:
                cov = self._m2 / (self.count - 1) + 1e-6 * np.eye(d)  # ridge
                delta = row - self._mean
                scores[i] = float(delta @ np.linalg.solve(cov, delta))
            self.count += 1
            delta = row - self._mean
            self._mean += delta / self.count
            self._m2 += np.outer(delta, row - self._mean)
        self._last_scores = scores
        return scores

    def transform_input(self, X: np.ndarray, names: list[str]) -> np.ndarray:
        self.score(X)
        return X

    def tags(self) -> dict[str, Any]:
        if self._last_scores is None:
            return {}
        return {"outlier_score": self._last_scores.tolist()}


def _parse_dtype(raw: Any, impl_name: str):
    """Map a graph-parameter dtype string to a torch dtype (None = f32)."""
    import torch

    dtypes = {"bfloat16": torch.bfloat16, "float16": torch.float16,
              "float32": None, None: None}
    if raw not in dtypes:
        raise GraphUnitError(
            f"{impl_name} dtype must be one of {sorted(k for k in dtypes if k)}, "
            f"got {raw!r}"
        )
    return dtypes[raw]


def _torch_generative(parameters: dict[str, Any], device: str) -> Any:
    """JAX_GENERATIVE: continuous-batching token generation on the port.

    Graph parameters as the JAX package reads them: ``family`` (default
    "llama"), ``preset``, ``n_slots``, ``max_new_tokens``, ``temperature``,
    ``top_k``, ``eos_id``, ``dtype``, ``rng`` (weight seed), ``checkpoint``
    (an npz the weights are read from in place of the seed),
    ``spec_heads_path`` (trained Medusa heads), ``seq_impl``,
    ``decode_block``, ``decode_kernel``, ``kv_block_size``, ``kv_blocks``,
    ``queue_max``, plus model-config overrides.  Parameters of features the
    port does not serve yet (``mesh``) raise (models/registry.py)."""
    from seldon_core_tpu_torch.models import registry

    params = dict(parameters)
    family = params.pop("family", "llama")
    dtype = _parse_dtype(params.pop("dtype", None), "JAX_GENERATIVE")
    try:
        return registry.build_generative_component(
            family, dtype=dtype, device=device, **params
        )
    except (KeyError, TypeError, ValueError) as e:
        raise GraphUnitError(str(e)) from e


# parameters of the JAX package's JAX_MODEL unit that belong to later
# slices of the port: the mesh (ROADMAP A15)
MODEL_LATER_PARAMS = ("mesh",)


def _torch_model(parameters: dict[str, Any], device: str) -> Any:
    """JAX_MODEL: a zoo family (``mlp``, ``cnn``, ``resnet``, ``bert``) on
    the device behind the batching queue.

    Graph parameters as the JAX package reads them: ``family`` (required),
    ``preset``, ``dtype``, ``max_batch``, ``max_delay_ms``, ``max_queue``,
    ``buckets`` (a comma-separated batch ladder, e.g. ``"16,32"``),
    ``input_dtype`` (warm the buckets for that wire dtype, e.g. ``"uint8"``
    images normalized on the device), ``class_names`` (a list, or a
    comma-separated string), ``batching``, ``rng`` (the weight seed),
    ``checkpoint`` (an npz of the family's flax variables, written by
    either package's ``save_checkpoint``; read in place of the seeded
    weights), plus config overrides (e.g. ``n_classes``).  ``mesh`` and a
    ``sharding`` other than ``default`` raise by name.  One parameter the
    JAX unit lacks: ``input_shape`` (a comma-separated row shape, e.g.
    ``"128"`` for BERT rows of 128 tokens) warms the buckets for that row
    shape; without it they are warmed for the family's example row (BERT:
    16 tokens), and a request of another row shape captures its graph at
    first use, as the JAX unit compiles it."""
    from seldon_core_tpu_torch.executor.compiled import BucketSpec
    from seldon_core_tpu_torch.models import registry

    params = dict(parameters)
    try:
        family = params.pop("family")
    except KeyError:
        raise GraphUnitError("JAX_MODEL requires a 'family' parameter") from None
    for name in MODEL_LATER_PARAMS:
        if params.pop(name, None) is not None:
            raise GraphUnitError(f"JAX_MODEL parameter {name!r} is not served by the "
                                 "PyTorch port yet")
    sharding = str(params.pop("sharding", "default")).strip()
    if sharding != "default":
        raise GraphUnitError(f"JAX_MODEL sharding={sharding!r} is not served by the "
                             "PyTorch port yet (only 'default')")
    dtype = _parse_dtype(params.pop("dtype", None), "JAX_MODEL")
    if "buckets" in params:
        params["buckets"] = BucketSpec(tuple(sorted(_positive_ints(params["buckets"],
                                                                   "buckets"))))
    if "input_shape" in params:
        params["input_shape"] = _positive_ints(params["input_shape"], "input_shape")
    if isinstance(params.get("class_names"), str):
        params["class_names"] = [c.strip() for c in params["class_names"].split(",")]
    try:
        return registry.build_component(family, dtype=dtype, device=device, **params)
    except (KeyError, TypeError, ValueError) as e:
        raise GraphUnitError(str(e)) from e


def _positive_ints(raw: Any, name: str) -> tuple[int, ...]:
    """A comma-separated list of positive ints (``"16,32"``)."""
    try:
        out = tuple(int(s) for s in str(raw).split(","))
        if any(s < 1 for s in out):
            raise ValueError(raw)
    except ValueError:
        raise GraphUnitError(
            f"{name} must be comma-separated positive ints, got {raw!r}") from None
    return out


def _graphllm(cls_name: str):
    """A ``graphllm/`` unit, imported when first built."""
    def build(parameters: dict[str, Any], device: str) -> Any:
        from seldon_core_tpu_torch import graphllm

        return getattr(graphllm, cls_name)(**parameters)

    return build


def _host(cls):
    """A host-only unit: its graph parameters are its keyword arguments."""
    return lambda parameters, device: cls(**parameters)


_BUILTINS: dict[Implementation, Callable[..., Any]] = {
    Implementation.SIMPLE_MODEL: _host(SimpleModel),
    Implementation.SIMPLE_ROUTER: _host(SimpleRouter),
    Implementation.RANDOM_ABTEST: _host(RandomABTest),
    Implementation.AVERAGE_COMBINER: _host(AverageCombiner),
    Implementation.EPSILON_GREEDY: _host(EpsilonGreedy),
    Implementation.THOMPSON_SAMPLING: _host(ThompsonSampling),
    Implementation.MAHALANOBIS_OUTLIER: _host(MahalanobisOutlier),
    Implementation.JAX_MODEL: _torch_model,
    Implementation.JAX_GENERATIVE: _torch_generative,
    Implementation.CASCADE_ROUTER: _graphllm("CascadeRouter"),
    Implementation.GUARDRAIL: _graphllm("Guardrail"),
}


def create_builtin(impl: Implementation, parameters: dict[str, Any],
                   device: str = "cuda") -> Any:
    """Instantiate a built-in implementation with its typed parameters."""
    try:
        factory = _BUILTINS[impl]
    except KeyError:
        raise GraphUnitError(
            f"no built-in implementation {impl.value!r} in this engine; it serves "
            f"{sorted(i.value for i in _BUILTINS)}"
        ) from None
    return factory(parameters, device)


def has_builtin(impl: Implementation) -> bool:
    return impl in _BUILTINS
