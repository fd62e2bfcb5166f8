"""Fault-plan model + parser for the chaos plane: the port's copy of the
JAX package's ``chaos/plan.py``, so that one plan text parses alike in
both packages (docs/RESILIENCE.md).

A plan is a semicolon-separated list of rules, each binding one fault
kind to one registered fault site::

    SCT_CHAOS_PLAN="disagg.handoff.send:torn:hits=2:frac=0.5;kube.watch:gone:times=3"

Rule grammar (colon-separated fields)::

    <site>:<kind>[:key=value ...]

``site``   a name from :data:`SITES` (unknown sites are a parse error —
           a typo'd plan must fail loudly, not silently inject nothing).
``kind``   what happens when the rule triggers:

           =========  ====================================================
           reset      raise ``ConnectionResetError`` at the site
           timeout    raise ``TimeoutError`` at the site
           ioerror    raise ``OSError`` at the site
           torn       truncate the byte payload passed to ``mangle()``
           slow       delay the site by ``delay_ms`` (slow peer)
           hang       delay the site by ``delay_ms`` (default 60 s)
           gone       site-interpreted: kube watch raises ``Gone`` (410)
           drop       site-interpreted: watch stream ends mid-flight
           status     site-interpreted: HTTP error, code in ``code=``
           exit       ``os._exit(code)`` — whole-process death (follower
                      kill); never fired from ``check()`` dry paths
           =========  ====================================================

Trigger selectors (all optional; default = fire on every arrival):

``hits=N``     fire on the Nth arrival at the site and afterwards
               (1-based) — "the second handoff is torn".
``only=N``     fire ONLY on the Nth arrival (shorthand for a
               one-shot at a known point in the sequence).
``times=K``    stop after the rule has fired K times (a 410 *storm*
               is ``gone:times=5`` — five relists, then clean).
``p=F``        fire with probability F per arrival, drawn from the
               plan's seeded RNG (``SCT_CHAOS_SEED``) so a given
               seed replays the identical fault sequence.

Fault parameters: ``delay_ms=D`` (slow/hang), ``frac=F`` (torn: keep
the first F of the payload, default 0.5), ``code=N`` (status/exit).
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Registered fault sites: name -> where it lives.  ``fire()``/``check()``
# on an unregistered site raises in plans and tests (catching typos).  The
# names are the JAX package's, all of them, so a plan parses alike in both;
# in the port the two ``disagg.*`` sites (the engine's handoff POST and peer
# prefix pull) and the two ``gw.*`` sites (the gateway) have a caller: the
# multihost and kube sites wait for the modules that hold them.
SITES: dict[str, str] = {
    "gw.forward": "gateway/app.py _forward — one upstream POST attempt",
    "gw.h1": "gateway/h1gateway.py — upstream connect for the h1 splice",
    "disagg.handoff.send": "engine/app.py _send_handoff — KV handoff POST "
                           "to the decode peer (torn mangles the frame)",
    "disagg.prefix.pull": "engine/app.py _maybe_pull_prefix — peer-tier "
                          "prefix pull",
    "mh.step": "executor/multihost.py lead() — per-step broadcast to "
               "followers (reset = follower death mid-decode)",
    "mh.follower": "executor/multihost.py follower_loop() — step receive "
                   "(exit = follower process kill)",
    "kube.request": "operator/kube_http.py _req — one apiserver call",
    "kube.watch": "operator/kube_http.py watch — the watch stream "
                  "(gone = 410 storm, drop = mid-watch disconnect)",
}

KINDS = frozenset({
    "reset", "timeout", "ioerror", "torn", "slow", "hang", "gone",
    "drop", "status", "exit",
})


class PlanError(ValueError):
    """Malformed SCT_CHAOS_PLAN — unknown site/kind or bad selector."""


@dataclass
class Rule:
    site: str
    kind: str
    hits: int = 0        # fire from the Nth arrival on (0 = always)
    only: int = 0        # fire ONLY on the Nth arrival (0 = off)
    times: int = 0       # max firings (0 = unlimited)
    p: float = 0.0       # per-arrival probability (0 = deterministic)
    delay_ms: float = 100.0
    frac: float = 0.5
    code: int = 13
    fired: int = 0       # mutable: how often this rule has triggered

    def matches(self, arrival: int, rng) -> bool:
        """Does this rule trigger on the site's ``arrival``-th hit?"""
        if self.times and self.fired >= self.times:
            return False
        if self.only:
            if arrival != self.only:
                return False
        elif self.hits and arrival < self.hits:
            return False
        if self.p and rng.random() >= self.p:
            return False
        self.fired += 1
        return True


@dataclass
class FaultPlan:
    rules: list[Rule] = field(default_factory=list)
    seed: int = 0

    def for_site(self, site: str) -> list[Rule]:
        return [r for r in self.rules if r.site == site]


_INT_KEYS = {"hits", "only", "times", "code"}
_FLOAT_KEYS = {"p", "delay_ms", "frac"}


def parse_plan(text: str, seed: int = 0) -> FaultPlan:
    """Parse ``SCT_CHAOS_PLAN``; raises :class:`PlanError` on any typo."""
    rules: list[Rule] = []
    for clause in (text or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        parts = [p.strip() for p in clause.split(":")]
        if len(parts) < 2:
            raise PlanError(f"chaos rule {clause!r}: want <site>:<kind>[...]")
        site, kind = parts[0], parts[1]
        if site not in SITES:
            known = ", ".join(sorted(SITES))
            raise PlanError(f"chaos rule {clause!r}: unknown site {site!r} "
                            f"(known: {known})")
        if kind not in KINDS:
            known = ", ".join(sorted(KINDS))
            raise PlanError(f"chaos rule {clause!r}: unknown kind {kind!r} "
                            f"(known: {known})")
        rule = Rule(site=site, kind=kind)
        for kv in parts[2:]:
            if "=" not in kv:
                raise PlanError(f"chaos rule {clause!r}: selector {kv!r} "
                                "is not key=value")
            key, val = kv.split("=", 1)
            key = key.strip()
            try:
                if key in _INT_KEYS:
                    setattr(rule, key, int(val))
                elif key in _FLOAT_KEYS:
                    setattr(rule, key, float(val))
                else:
                    raise PlanError(
                        f"chaos rule {clause!r}: unknown selector {key!r}"
                    )
            except ValueError as e:
                raise PlanError(
                    f"chaos rule {clause!r}: bad value for {key!r}: {e}"
                ) from None
        rules.append(rule)
    return FaultPlan(rules=rules, seed=seed)
