#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``seldon_core_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``build``: the CUDA kernels are compiled from ``seldon_core_tpu_torch/csrc``
   (one nvcc per source, all started together) and loaded; the line lists
   each kernel's registers, shared memory and spills (``ptxas -v``) and its
   ``HGMMA``/``HMMA`` count (``cuobjdump -sass``).
2. ``kernel_check``: each kernel against its plain PyTorch version on the
   card, at the main path's shapes (llama3-1b: H=32, KV=8, D=64, 16-row
   pages): flash attention at every prefill bucket, ragged and prime
   lengths, grouped and repeated K/V, strided views, no mask, other head
   dims, in bf16, f16 and f32, and its bottom-right causal variant (Sq
   suffix rows over Sk >= Sq keys, 80 over 592 as served), whose rows must
   be the bits of the same rows of a cold causal call over the whole
   padded bucket; paged attention at 1-4 queries per slot,
   int8 pages, position 0, positions on and off page boundaries, one split
   and many, slots whose later splits are empty and rows that see nothing,
   and at head dim 128 (llama3-8b) and 8- and 32-row pages; and every
   query j of a verify pass (L = 4) must give the bits of a decode step
   (L = 1) at pos + j.
3. ``reference``: a 2-layer model at llama3-1b width in f32 on the card
   against the same weights on the CPU (plain versions): prefill logits,
   teacher-forced decode logits and greedy tokens over a float pool and
   over an int8 pool (16 steps; the int8 pool bytes equal but for a stated
   share of one-step rounding ties); then, on the card, a prompt whose
   first 2 blocks are already in the prefix index against the same prompt
   cold, and ``prefill_chunk=64`` over a 300-token prompt against the
   monolithic prefill (first-token logits, 16 greedy tokens, and the
   reuse and chunk counts those two must show; in bf16, over a float and
   an int8 pool, the logits must be bit-equal); and speculative decoding
   at ``spec_draft=3``
   with each proposer (``ngram``, ``heads`` made from the ``lm_head``,
   ``draft`` with ``truncate:1``): greedy streams on the card equal to
   speculation off on the card and to speculation on on the CPU, with a
   non-empty acceptance ledger; and the llama3-8b geometry (hidden 4096,
   32 heads, 8 KV heads, head dim 128, vocab 128256) at 2 of its 32
   layers, the card in bf16 against the CPU f32 port on the same weights:
   first logits within ``REF_BF16_TOL``, greedy tokens reported.
4. ``graphs``: a decode block replayed from its CUDA graph against the
   same block run eagerly on the card from the same state (llama3-1b
   width, 2 layers, bf16, 8 slots, 16-step blocks): tokens, emitted mask
   and every pool byte bit-equal, and the same kernel launches counted,
   for a float pool (greedy, sampled, sampled with top-k), an int8 pool
   (greedy, sampled) and each proposer (greedy; ``ngram`` sampled too).
5. ``serve``: the engine boots in-process on 127.0.0.1 with a
   ``JAX_GENERATIVE`` llama3-1b bf16 graph (seeded weights, 8 slots,
   16-step decode blocks, float pool) and answers concurrent strData
   requests over HTTP, every block a graph replay with the overlap on; the
   kernels' launch counts are read around this phase, and it fails unless
   every decode block cost exactly one host sync, a block continued from
   the carry, the captures stayed those of warmup (one per window
   bucket), and the same wave with the overlap off and on the eager loop
   gave the same streams; it prints a cold prefill's ms with and without
   the row tiles.
6. ``serve_cached``: the same graph with ``kv_cache_dtype=int8``,
   ``kv_prefix_reuse=true`` and ``prefill_chunk=256``: one warm request (a
   512-token prefix + 24), then a wave of six requests sharing that prefix
   (64 new tokens each) and, once their first block is delivered, two
   unshared ones of 1500 and 1900 tokens that the scheduler paces chunk by
   chunk.  It fails unless every reply is 200 with its valid tokens, six
   prefills reused the prefix, a chunk was paced while streams decoded
   (``chunks_paced``; chunks run back to back with no live stream are not
   counted), each decode block cost one host sync, both kernels launched,
   the suffix prefills launched flash attention, and every stream equals
   the same prompt's on a fresh int8 engine with reuse and chunking off;
   it prints TTFT of the shared and the long requests, the block time
   after a paced chunk and without one, a suffix prefill's and a chunk's
   host ms, and the pool's bytes per 2048-token slot, int8 and bf16.
7. ``serve_spec``: the ``serve`` graph with ``spec_draft=3``, once per
   proposer (``ngram``; ``heads``; ``draft`` with ``truncate:auto``, 2 of
   16 layers; and ``draft`` with ``preset:llama3-1b`` seeded as the served
   weights, the model drafting for itself), each answering a wave of the
   ``serve`` prompts plus a repetitive one.  It fails unless each decode
   block cost one host sync, the paged kernel ran verify passes (L = 4),
   for ``draft`` flash attention prefilled the draft pool, the
   self-draft had drafts accepted, and every greedy stream equals the
   ``serve`` phase's bit for bit (bf16; the verify pass runs the ops
   whose rows the card rounds otherwise at 32 rows than at 8 once per
   query position); it prints accepted tokens per verify pass, ms per
   pass, wave tokens/s, TTFT, each stream's agreement, and (``ngram``)
   each verify row against a plain step at pos + j and which ops of a
   layer keep a row's bits at 32 rows.
8. ``serve_disagg``: two engines in one process over loopback HTTP, the
   ``serve`` graph with explicit ``kv_blocks``: A in the ``prefill`` role
   (``SCT_DISAGG_DECODE`` naming B) and B in the ``decode`` role.  The
   serve wave's distinct prompts through A's ``/disagg/generate`` must
   all answer ``mode == "disagg"`` with ``serve``'s streams bit for bit,
   with flash attention launched on A only and paged attention on B only;
   again with int8 pools against a unified int8 wave on B.  B refuses a
   frame of 8-row pages (409); a third engine C pulls a prompt's
   512-token prefix chain from A (``SCT_PREFIX_PEER_PULL=1``, the
   ``x-sct-prefix-peer`` header) and serves it from the peer tier with
   A's tokens; with B stopped, A answers ``unified-fallback`` with the
   same tokens (the 600-token prompt's reused prefix and suffix prefill
   give ``serve``'s cold stream) and its free-block count back where it
   was.  Then the
   DRAM tier: ``prefix_dram_gb`` with a 128-block pool in which a
   1500-token prompt evicts a warmed 512-token prefix, promoted back for
   a prompt sharing it, must give the streams of a pool with room for
   all of it.  It prints handoff bytes per request, export and import
   ms, TTFT (client send to the decode engine's first token) and wave
   tokens/s beside ``serve``'s, and the DRAM tier's counters.
9. ``serve_stream``: the serve graph streams a reply over
   ``/api/v0.1/predictions/stream`` (SSE): it must equal the unstreamed
   reply, in one write per decode block (the first token alone); a client
   that leaves mid-stream frees its slot once (the free block count comes
   back, none twice); ``/pause`` turns ``/ready`` to 503 and ``/unpause``
   back.
10. ``serve_graph``: inference graphs on the card.  Engine G1:
   ``guard`` (GUARDRAIL, PII scrub, a block rule) -> ``casc``
   (CASCADE_ROUTER, ``ttft_ms`` 50) -> [``small``: llama3-1b with
   ``conf_signal`` and ``embed``; ``large``: llama3-8b (32 layers, bf16,
   seeded weights, ``max_seq`` cut from 8192 to 2048)].  With the
   threshold at 0 no request escalates and every reply is byte-equal to
   ``small.predict_raw`` of the same body, its tokens ``serve``'s
   streams; at +inf every request escalates and every reply is
   byte-equal to ``large.predict_raw`` (``meta.routing.casc`` 1); at +inf
   under ``x-sct-deadline-ms: 30000`` with the next tier's ``ttft_ms`` set
   to 60 s the reason is ``deadline-budget`` and tier 0 serves; a decode
   block replayed from its graph, and the block continued from its carry
   before the first is fetched, give the margins
   of the eager loop bit for bit; one sync per decode block with the
   signal on; ``/api/v0.1/embeddings`` over the prompts costs one fetch
   for the wave, launches flash attention, and each vector is within
   cosine 0.999 of the CPU f32 port at full depth; a prompt in two
   buckets gives the same vector within 1e-3; an e-mail address in the
   body is scrubbed and a block rule answers FAILURE.  Engine G2 (after
   G1 is closed): ``ab`` (EPSILON_GREEDY, epsilon 0.2, seed 7) ->
   [``g0``, ``g1``: llama3-1b width at ``BANDIT_LAYERS`` (4) of its 16
   layers, seeds 0 and 1; the cut keeps the run's time: no gate of G2
   reads depth], 32 requests each followed
   by ``POST /api/v0.1/feedback`` (reward 1 on branch 1): the branches
   equal a host-only ``EpsilonGreedy`` fed the same rewards, and each
   reply equals its branch called directly.  It prints TTFT and wall p50
   shipped cheap against escalated, the 8b's decode step ms and capture
   seconds, the escalations and ``served_by_tier``.
11. ``serve_lora``: batched multi-LoRA on the serve graph with
   ``lora_rank=16``, ``lora_slots=8``, ``lora_targets=qkvo+mlp`` and four
   adapters.  Engine B adds ``kv_prefix_reuse``, ``prefill_chunk=256`` and
   ``spec_draft=3``; engine A, in the ``prefill`` role with B as its decode
   peer, answers serve's 8 prompts with adapters ``[none, alpha, beta,
   none, gamma, delta, alpha, none]`` over HTTP, then one wave per
   adapter.  It fails unless the ``none`` streams equal ``serve``'s bit
   for bit, each adapter row equals its adapter's wave and differs from
   the base stream, B's mixed wave equals A's, a 512-token prefix under
   alpha, beta, alpha reuses 0, 0 and 512 tokens with the streams of A
   (cold), A's handoffs of the adapter rows to B answer ``disagg`` with
   A's streams, B refuses a frame naming an adapter it lacks by name
   (409), every block costs one sync, no graph is captured after warmup
   across a registration that fills A's pool and one more, made while a
   wave decodes, that evicts the least recently used idle row, a block
   replayed through the rewritten row equals the eager block (tokens,
   mask, every pool byte), the new adapter's wave on A (through the
   rewritten row) equals its wave on B (a row no adapter held, once B
   registers it too) and differs from every other adapter's wave and the
   base streams, and the ledger's ``adapter_pool`` is
   ``lora_pool_bytes`` (180,355,072).  It prints the decode step with the
   deltas on and off from one admitted state (CUDA events, five
   alternating pairs), the delta ops the probes split, and the ledger.
12. ``serve_zoo``: the predict path, ``JAX_MODEL`` units at full width
   (ResNet-50 224x224x3 with 1000 classes, BERT-base at 128 tokens, the
   deep_mnist CNN and the MLP at ``default``), bf16 unless stated.  Z0:
   each family on seeded weights whose biases, norm scales and BatchNorm
   statistics are drawn from the seed, the card in float32 (TF32 off)
   against the CPU in float32 on 4 rows (BERT: rows padded after 100 and
   17 tokens and one of only padding), within ``ZOO_F32_TOL`` of the
   log-probabilities' scale; ResNet's uint8 ingest against the pixels
   normalized on the host; then the card in bf16 against the same (the
   largest difference and the argmax agreement printed).  Z1: the largest
   bucket replayed from its CUDA graph against the eager forward of the
   same input, bit-equal, and no capture after warmup; it prints device
   ms a step replayed, eager ms, host ms a dispatch, rows/s, FLOPs a row
   (from the operations' shapes) and the share of 989 TFLOP/s.  Z2: the
   in-process engine serves the JAX bench's graphs: ResNet-50
   (``input_dtype=uint8``, ``buckets=16,32``, 24 concurrent 16-image
   uint8 ``rawTensor`` requests), BERT-base (``buckets=64,256``,
   ``input_shape=128``, 16 concurrent 64-row int32 requests), an
   ``EPSILON_GREEDY`` A/B over two ResNet-50 (32 requests, each followed
   by ``/feedback``: the branches equal a host-only bandit's, both
   taken) and ``MAHALANOBIS_OUTLIER`` before an ``AVERAGE_COMBINER`` over
   two BERT-base.  Every reply is 200, sums to 1 a row, equals its unit
   (or the units' mean) called alone within ``ZOO_BF16_TOL``, carries the
   routing or the outlier tags; one host sync a device step and no
   capture after warmup.  It prints predictions/s, request p50/p99, rows
   a step and a request's host wire costs; neither kernel launches.
13. ``serve_cache``: the response tiers on the serve graph with ``embed``
   on, ``SCT_CACHE=1`` and ``SCT_SEMCACHE=1``.  C1: serve's 8 prompts
   sent concurrently give serve's (cache-off) streams; the same bodies
   again, keys reordered and spaced otherwise, are all ``x-sct-cache:
   hit``, byte-equal, and spend no prefill, decode block or embed.  C2:
   16 identical concurrent bodies on a cold key are one admission into a
   slot, 16 byte-equal replies and 15 collapsed followers.  C3: with the
   exact tier flushed, a C1 body is a ``semantic`` hit (similarity >=
   0.95); an unrelated prompt hits exactly when its ``/embeddings``
   cosine to a cached prompt is >= 0.95; the C1 prompt with 48 new tokens
   misses and gets its 48 (ROADMAP C7).  C4: ``RANDOM_ABTEST`` over two
   zoo MLP units: the engine tier is not bound, repeated rows hit the
   node tier and spend no step.  C5: a unit at temperature 0.8 binds
   neither tier.  It prints hit and miss p50, the K1 launches and ms of
   an embed.
14. ``serve_qos``: admission on the serve graph with ``kv_prefix_reuse``
   and ``prefill_chunk=256``, each part under its own controller from
   ``SCT_QOS_*`` knobs.  Q1: 32 concurrent requests of 64 tokens under
   ``MAX_INFLIGHT=8``, ``MAX_QUEUE=8``: 200 or 429, every 429 with
   ``Retry-After`` >= 1, admitted + shed = 32, every 200's stream equal
   to its prompt served alone.  Q2: with all slots busy, 8 ``batch`` then
   8 interactive requests: the batch ones above ``max_queue x (1 -
   interactive_reserve)`` get 429 while interactive ones are admitted,
   and interactive requests take slots before the batch ones queued
   beside them.  Q3: ``x-sct-deadline-ms: 1`` behind full slots is a 504
   with no prefill spent; a deadline passing mid-decode is a 504 reaped
   at the next sync point while the wave's other streams equal their
   solo streams, one host sync a block; a 1900-token prompt whose
   deadline passes between its 256-token chunks is a 504 whose blocks
   are back and none of whose blocks entered the prefix index.  Q4: 8
   admitted and 24 shed inside a 2 s window start a brownout: an
   interactive request for 64 tokens gets 16 (the first 16 of its
   unclamped stream), a batch request 429 ``brownout``, and after the
   3 s cooldown 64 again.  Q5: with both EWMAs holding samples, a budget
   under ``predicted_completion_ms`` is a 429 ``predicted-slo-miss`` with
   no prefill spent.  The usage meter over the phase: every request
   counted once (completed, shed, reaped), the decode tokens equal the
   delivered ones less each started request's first (its prefill's)
   plus the wasted, and the device seconds equal the blocks' within 1%.
   It prints an admission's host us, the EWMAs and the 429 and 504
   counts.
15. ``serve_remote``: remote graph nodes.  Each microservice is a
   subprocess of the port's runtime command line
   (``python -m seldon_core_tpu_torch.runtime.microservice``) on a free
   loopback port, waited on at ``/ready`` and killed at the end; a child
   that does not boot fails the phase.  R1 (BASELINE config 1): the engine
   serves ``examples/iris``'s single-node graph, its unit a REST
   microservice of ``IrisClassifier.py``: 64 requests of 1-8 rows from a
   seed one at a time, then again over 16 clients, each reply equal to
   ``IrisClassifier().predict`` on the host (to the float64 JSON round
   trip) with names ``setosa, versicolor, virginica``; the pool opens
   one connection one at a time and at most 16 in the wave; a
   form-encoded request answers the same.  R2:
   ``examples/transform-pipeline/graph.json`` over three children
   (``Standardize``, ``Scorer``, ``ArgmaxLabel``), every reply equal to
   the three classes composed in-process.  R3: a remote ROUTER (a numpy
   class, ``--persistence 1`` on a file store) before two branches,
   llama3-1b (bf16, seeded weights, ``seq_impl=flash``) and
   ``SIMPLE_MODEL``: serve's 8 prompts routed to the 1b answer ``serve``'s streams and the unit's
   own called directly, both kernels launch; one feedback a reply
   reaches the router once (its tags count 8); the router restarts
   (SIGTERM flushes its state) and comes back with 8.  Then ROADMAP C9's
   pin: ``serve_cache``'s C5 unit (2 layers, temperature 0.8, embed on)
   booted and warmed 8 times, the engine before it closed and dropped
   while it captures, the collector's objects frozen and its thresholds
   lowered, every decode-graph capture succeeding.  It prints the client wall p50/p99
   one at a time and in the wave, the pool's connections, the hop's ms on
   the engine's side and the captures.
16. ``serve_pack``: chip packing and live drain at llama3-1b width.  P1:
   one engine boots the primary ``chat`` (``pack_slo_ms`` 50) and, from
   ``ENGINE_CO_PREDICTORS``, ``bulk`` (``pack_class=batch``, top-k 40, its
   own seed); both register with the device arbiter and warm in turn.  A
   16-client chat burst (32-256-token prompts, 32 new tokens) with bulk
   idle, then another mid-way through 8 bulk requests (64-512-token
   prompts, 256 new tokens, driven through bulk's unit in the engine's
   loop), then a third mid-way through a seeded top-k pair.  It fails
   unless the arbiter preempted bulk, every suspend resumed, the suspend
   store and the host ledger's ``suspend_dram`` are back at 0, every bulk
   stream equals the same request on a sole bulk engine and the pair its
   own uninterrupted run, no graph was captured after warmup on either
   tenant and each decode block cost one host sync.  P2: a second engine
   with chat's weights; ``/admin/drain {"peer": ...}`` moves 8 live chat
   streams (256 new tokens), each equal to its uninterrupted run on the
   peer, ``migrated`` 8 and the source's blocks all free.  P3: the same
   with ``disagg.handoff.send:torn:only=1``: 7 migrate, 1 resumes here,
   all equal, ``/stats/chaos`` shows 1 fired.  P4: ``/admin/drain {}``
   parks the 8, a repeat is a 409 with ``phase: parked``,
   ``/admin/undrain`` resumes them with equal tokens.  It prints chat's
   TTFT p50/p99 with bulk idle and decoding, bulk tokens/s before, during
   and after a burst, the suspend ms and bytes a slot and the arbiter's
   grants, beside the card's name and power limit.
17. ``serve_obs``: the telemetry plane at llama3-1b width.  O1: engine A
   with every plane on (the timeline, trace-id exemplars, spans exported
   to a loopback stdlib OTLP collector) takes 32 distinct prompts of
   32-600 tokens (32 new tokens, greedy) from the port's load harness
   (``testing/loadtest.py``, 2 spawned client processes); engine B, with
   every plane off, takes the same.  It fails unless B's tokens equal A's,
   each decode block counted one host sync and none was captured after
   warmup, ``/prometheus`` (parsed here) counts 32 requests and the
   tokens received, the ``engine-rest`` wire edge counts the harness's
   bytes, every trace id the harness saw has timelines with a terminal
   reason and reached the collector, a TTFT exemplar names one, the
   ``/stats/*`` routes answer and the decode ``mfu`` gauge is in (0, 1].
   O2: B in the prefill role hands a traced request to A: one trace id
   holds ``handoff.export`` (B) and its child ``disagg.import`` (A), and
   the prefill and imported timelines.  O3: ``/profile/start`` and
   ``/stop`` around a wave on A: the Chrome trace must hold K1's kernels,
   graph launches and K2's kernels (from the replays, else from a second
   wave on the eager loop); it prints the top 10 device ops and the
   event loop's busy share.  O4: a ResNet-50 unit behind the batching
   queue: one host sync a step and an ``mfu`` gauge equal to the
   roofline's FLOPs over the measured step.  It prints the harness's
   p50/p99 and the wave's tokens/s with the planes on and off.
18. ``serve_checkpoint``: weights from disk at llama3-1b width (bf16),
   written under a temporary directory removed at the end.  S1:
   ``serve``'s seeded weights saved with the port's ``save_params``
   (about 2.2 GB) and an engine booted with them through the
   ``checkpoint`` graph parameter: every loaded bf16 leaf bit-equal to the
   saved one (never widened on the host), ``serve``'s 8 greedy streams,
   one sync a block; it prints the file's bytes, the save seconds, the
   load seconds (host read and upload apart) and the seconds to
   ``/ready``, beside the seeded weights' making and ``serve``'s boot.
   S2: the Medusa heads ``serve_spec`` synthesizes at ``spec_draft=3``
   (``w1 (3, 2048, 2048)``, ``head (3, 2048, 32000)``) saved and served
   through ``spec_heads_path``: loaded bit-equal, the streams of
   speculation off, the acceptance ledger of ``serve_spec``'s heads run
   on the same wave, one sync a block; a malformed heads file refused at
   boot by name.  S3: ``chat`` and ``bulk`` (batch, top-k 40,
   ``spec_method=draft``, ``truncate:auto``) packed as in ``serve_pack``,
   a 16-client chat burst mid-way through 8 bulk requests: bulk's streams
   equal ``serve_pack``'s sole bulk engine's, after warmup
   ``draft_prefills`` equals bulk's admissions (imports of resumed slots
   included), every draft prefill ran from the deferral under
   the ``{name}/draft`` registrant's grant, none inline, one sync a block; it prints chat's
   TTFT p50/p99 and bulk's tokens/s before and during the burst.  S4: a
   ResNet-50 unit's ``save_checkpoint``, then a unit of another seed
   booted with ``checkpoint``: the same 16-image request gives equal
   replies.  S5: when ``transformers`` imports, a tiny random HF Llama
   converted by ``models/convert.py`` and its logits on the card (f32)
   against transformers' on the CPU within ``HF_TOL``; else reported as
   skipped with the reason.
19. ``serve_gateway``: the port's gateway, spawned as its own process
   through its entry point (``python -m seldon_core_tpu_torch.gateway.app``,
   ``SCT_GW_ROUTE_POLL_S=0.25``, ``SCT_FLEET_POLL_S=0.5``,
   ``SCT_GW_UPSTREAM_CONNS=16``), in front of two llama3-1b engines
   (``serve``'s graph with ``kv_prefix_reuse``) as replicas A and B of one
   deployment.  W1: a token for the right secret; 401 for a wrong secret
   and for no token; 400 for conflicting ``Content-Length`` headers and a
   header name with a space before its colon, 411 for a chunked upload
   (the JAX splice front's statuses), 404 for an unknown route.  W2:
   ``serve``'s prompts as a concurrent wave through the gateway equal the
   same wave sent straight to A and ``serve``'s streams, three pairs; the
   ``gateway-h1`` wire edge counts the bytes the clients sent and
   received; it prints the gateway's added ms (p50, p99; the median of the
   pairs; each wave's engine-side TTFT and prefills by replica; and the
   same 8 requests one at a time, direct then through the gateway) and its
   CPU seconds a request.  W3: a 512-token prefix warmed by
   one request; after a poll, 8 requests sharing it (32-64-token
   suffixes) all go to that replica (``/stats/route``), which reuses 512
   tokens for each (8 reuses) while the other prefills none and K1 runs the
   suffix prefills; their streams equal the same 8 prompts prefilled cold
   on the other replica; a prompt with no shared prefix is one p2c pick;
   it prints the routed and cold TTFT p50.  W4: an SSE stream through the
   splice equals a direct one, its first event before its last block.
   W6 (before W5): ``/stats/fleet`` lists both replicas and its request
   count equals the engines' own ``/stats/summary`` counts; ``/feedback``
   through the fallback core moves the gateway's reward counter.  W5: B
   closed; every request answers 200 from A (a refused connect moves to
   A), within its timeout, ``/stats/route`` shows B's digest cleared and
   its breaker open; B rebooted on its port is picked again.  W6 (tap): a
   second gateway with ``GATEWAY_TAP_BROKER`` on the port's taplog broker
   gives one record a tapped request, keyed by its puid.  It prints each
   engine's seconds to ``/ready`` and the phase's seconds.
20. ``serve_grpc``: the gRPC plane through the port's own client
   (``FastGrpcChannel``; the card has no grpcio).  G1: a llama3-1b engine
   with a gRPC port: ``Seldon/Predict`` over ``serve``'s prompts equals
   the REST replies and ``serve``'s streams, ``StreamPredict`` the SSE
   stream; the JAX refusals answer status 3 with the JAX texts; the
   ``engine-grpc`` edge counts the client's bytes.  G2: the gateway
   process's relay (``--grpc-port``) with an ``oauth_token``: the same
   tokens, 401 FAILURE replies for a missing or wrong token, status 16 on
   a stream, the ``gateway-grpc`` edge's framed bytes, a ``traceparent``
   in the engine's timeline, and a stream whose client drops its
   connection after 2 messages frees its slot.  G3: Iris and the
   transform pipeline behind GRPC nodes (``microservice ... GRPC``
   children) equal the same graphs over REST nodes; ResNet-50's 16-image
   uint8 rawTensor answers bit for bit over both fronts (each front's
   predictions/s printed).  G4: the engine's CLI with ``--workers 2`` and
   ``SELDON_DEPLOYMENT_ID``: both processes listen on both ports, both
   answer fresh connections on each front (read from ``/proc``), the
   edges carry the deployment's name.  Its launches leave out the REST
   and SSE references.
21. ``kernel_times``: each kernel's time at the main path's shapes and at a
   long one (flash at S=2048 and its variant at 80 rows over 592 keys,
   against SDPA with the lower-right causal mask; paged at 8 slots near
   position 2000; paged
   also over int8 pages with bf16 scales at both, and at 4 queries per
   slot as a verify pass reads, beside the K/V bytes it reads; both at the
   8b's head dim 128 at the served shapes) beside its plain
   version, one PyTorch library call where there is one, and the least
   time the card could take (its bound).  ``ms`` replays the launches
   from a CUDA graph; ``eager_ms`` launches them from Python one by one,
   as the eager decode step does; ``host_ms`` is the host's cost of one
   call.

Then the card's name and power limit (nvidia-smi), one line listing the
kernels (launches summed over the serve phases, ``serve_graph``,
``serve_lora``, ``serve_zoo``, ``serve_cache``, ``serve_qos``,
``serve_remote``, ``serve_pack``, ``serve_obs``, ``serve_checkpoint``,
``serve_gateway`` and ``serve_grpc`` included),
and as the last line
``{"ok": true, "device": {...}}``.  Any
failed phase exits non-zero before that line.  Without CUDA, or without
the repository beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import unittest.mock
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, NVIDIA data sheet
# kernel vs plain, both f32 inside: (abs, rel).  Sums in another order
# only; in bf16 the kernel's output is also rounded once to bf16 (at most
# half an ulp, 2**-8 of the value) against the plain version run in f32 on
# the same bf16 inputs, so the relative limit sits just above 2**-8 and the
# absolute one covers f32 noise near zero.
F32_TOL = (2e-4, 2e-4)
BF16_TOL = (1e-4, 4e-3)
# The 16-bit flash kernel also rounds each probability once to the input's
# type before P.V (wgmma takes 16-bit operands): at most u = 2**-8 (bf16)
# or 2**-11 (f16) of each p, so its output may move by u * (P.|V|) more,
# with P.|V| from the plain version in f32.
P_ROUNDING = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
SERVE_PRESET = "llama3-1b"
SERVE_SLOTS = 8
SERVE_BLOCK = 16
MAX_NEW = 32
VERIFY_PROMPT = [5, 9, 2, 17, 3]
SERVE_LENGTHS = (5, 17, 64, 100, 211, 333, 480, 600)  # the wave's prompt lengths
LONG_POS = [1990, 1995, 2000, 2001, 2007, 1999, 2010, 2015]  # K2's long timing: near a 2048 window
# serve_cached: a shared 512-token prefix, six shared prompts' suffix
# lengths, two unshared long prompts chunked by 256 (6 and 8 chunks)
CACHED_PREFIX = 512
CACHED_CHUNK = 256
SHARED_SUFFIXES = (8, 17, 24, 33, 47, 64)
SHARED_NEW = 64  # the shared streams decode 4 blocks: live while the long prompts' chunks pace
LONG_LENGTHS = (1500, 1900)
# speculation: draft length, the proposers' graph parameters, and the
# repetitive prompt added to the serve wave (a 40-token cycle of 8 tokens)
SPEC_DRAFT = 3
SPEC_METHODS = {
    "ngram": {"spec_method": ("ngram", "STRING")},
    "heads": {"spec_method": ("heads", "STRING"), "spec_heads": (SPEC_DRAFT, "INT")},
    "draft": {"spec_method": ("draft", "STRING"), "spec_draft_model": ("truncate:auto", "STRING")},
    # a preset draft seeded as the served weights are (rng 0): the model
    # drafts for itself, so drafts are accepted on the card at full width
    # (not a deployment: the draft costs what the model does)
    "draft_self": {"spec_method": ("draft", "STRING"),
                   "spec_draft_model": ("preset:" + SERVE_PRESET, "STRING")},
}
REPEAT_CYCLE, REPEAT_LEN = 8, 40
# int8 pools on the card and the CPU quantize K/V rounded ~1e-6 apart; a
# row whose x / scale sits that close to a half step rounds the other way.
# A flipped byte moves that element by one step and the next layer's K/V
# by more, so ties multiply with depth: at most this share of the int8
# bytes may differ, each by exactly one step.
INT8_TIE_SHARE = 0.01
# bf16 on the card against f32 on the CPU, same (bf16-valued) weights: every
# product and norm rounds its output to bf16 (2**-8 relative) where the CPU
# keeps f32, so logits move by a few such roundings of their scale; the
# limit is a share of max(1, the logits' largest magnitude)
REF_BF16_TOL = 0.05
# serve_graph: the cascade's tiers and the bandit graph's requests
GRAPH_LARGE = "llama3-8b"
GRAPH_LARGE_MAX_SEQ = 2048  # cut from 8192: the 1b's window and prefill buckets
GRAPH_TTFT_MS = 50
BANDIT_REQUESTS = 32
BANDIT_LAYERS = 4  # G2's branches: llama3-1b width, cut from 16 layers


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _sync():
    import torch

    torch.cuda.synchronize()


def time_ms(fn, arg_sets, iters: int = 20) -> float:
    """Mean device time of ``fn(*args)`` over ``iters`` launches, cycling
    through ``arg_sets`` so that no launch finds its inputs in L2.  The
    launches are captured in one CUDA graph and replayed, so the host's cost
    of a call (``host_ms``) does not leave the card idle between them.  The
    warm-up runs on the capture stream, so that nothing a wrapper keeps per
    stream is first allocated inside the capture."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for args in arg_sets[:3]:
            fn(*args)
    _sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    _sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def eager_ms(fn, arg_sets, iters: int = 20) -> float:
    """Mean time per call of ``iters`` eager calls of ``fn`` launched back to
    back, CUDA events around them (PR 1's ``time_ms``): where a call's host
    cost exceeds its kernel's time, this is what the eager decode step
    pays per call, not the kernel's own time."""
    import torch

    for args in arg_sets[:3]:
        fn(*args)
    _sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, arg_sets, iters: int = 50) -> float:
    """Mean host time of one eager call of ``fn`` (checks, allocation and
    the launch's enqueue): 50 calls never fill the launch queue, so the
    card's own time does not enter."""
    for args in arg_sets[:3]:
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    t1 = time.perf_counter()
    _sync()
    return (t1 - t0) * 1e3 / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got, want, tol: tuple[float, float], extra=None, **shape) -> dict:
    """``got`` against ``want`` within ``tol[0] + tol[1] * |want|``, plus
    ``extra`` (a tensor like ``want``) where a kernel rounds more than once."""
    import torch

    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output not finite at {shape}")
    err = (got.float() - want.float()).abs()
    limit = tol[0] + tol[1] * want.float().abs()
    if extra is not None:
        limit = limit + extra
    max_abs = float(err.max()) if err.numel() else 0.0
    ok = bool((err <= limit).all())
    rec = {
        "kernel": name, **shape, "max_abs_err": max_abs,
        "max_rel_err": float((err / want.float().abs().clamp_min(1e-6)).max()) if err.numel() else 0.0,
        "max_err_over_limit": float((err / limit).max()) if err.numel() else 0.0,
        "atol": tol[0], "rtol": tol[1], "p_rounding": extra is not None, "ok": ok,
    }
    if not ok:
        emit({"phase": "kernel_check", **rec})
        raise AssertionError(f"{name} disagrees with its plain version at {shape}")
    return rec


# ----------------------------------------------------------------- phases


def phase_build() -> None:
    from seldon_core_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - t0
    emit({
        "phase": "build", "seconds": seconds, "nvcc_seconds": _build.build_seconds,
        "sources": [f"seldon_core_tpu_torch/csrc/{s}" for s in _build.SOURCES],
        "kernels": _build.kernel_report(),
    })


def _flash_inputs(S, H, KV, D, dtype, seed, B=1):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, KV, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, KV, D, generator=g, device="cuda").to(dtype)
    return q, k, v


def _paged_inputs(S, L, H, KV, D, BS, NB, WB, dtype, seed, *, quant=False, pos=None):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(S, L, H, D, generator=g, device="cuda").to(dtype)
    table = torch.stack(
        [torch.randperm(NB - 1, generator=g, device="cuda")[:WB] + 1 for _ in range(S)]
    ).to(torch.int32)
    if pos is None:
        pos = torch.randint(0, WB * BS - L, (S,), generator=g, device="cuda")
    pos = torch.as_tensor(pos, device="cuda").to(torch.int32)
    kw = {}
    if quant:
        k = torch.randint(-127, 128, (NB, BS, KV, D), generator=g, device="cuda").to(torch.int8)
        v = torch.randint(-127, 128, (NB, BS, KV, D), generator=g, device="cuda").to(torch.int8)
        kw["k_scale"] = (torch.rand(NB, BS, KV, generator=g, device="cuda") * 0.02).to(dtype)
        kw["v_scale"] = (torch.rand(NB, BS, KV, generator=g, device="cuda") * 0.02).to(dtype)
    else:
        k = torch.randn(NB, BS, KV, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(NB, BS, KV, D, generator=g, device="cuda").to(dtype)
    return (q, k, v, table, pos), kw


def _f32(x):
    return x.float() if x.is_floating_point() else x


PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)  # llama3-1b, max_seq 2048


def _flash_cases():
    """(dtype name, case) for every flash check: ``case`` holds the entry
    (``blhd`` or ``bhsd``), shapes and how q/k/v are laid out."""
    cases = []
    for dn in ("bfloat16", "float16", "float32"):
        lengths = PREFILL_BUCKETS + (100, 257) if dn == "bfloat16" else (16, 100, 257, 2048)
        for S in lengths:
            cases.append((dn, {"entry": "blhd", "S": S, "H": 32, "KV": 8, "D": 64}))
        cases += [
            (dn, {"entry": "blhd", "S": 257, "H": 32, "KV": 32, "D": 64}),  # K/V repeated to H
            (dn, {"entry": "blhd", "S": 257, "H": 32, "KV": 8, "D": 64, "fused": True}),
            (dn, {"entry": "bhsd", "S": 257, "Sk": 257, "H": 32, "KV": 8, "D": 64}),
            (dn, {"entry": "bhsd", "S": 100, "Sk": 257, "H": 32, "KV": 8, "D": 64}),
            # the bottom-right causal variant (suffix prefills): a served
            # shape (80 suffix rows over a 512-row prefix) and ragged ones
            (dn, {"entry": "blhd", "S": 80, "Sk": 592, "H": 32, "KV": 8, "D": 64}),
            (dn, {"entry": "blhd", "S": 100, "Sk": 357, "H": 32, "KV": 8, "D": 64}),
            (dn, {"entry": "blhd", "S": 16, "Sk": 1040, "H": 32, "KV": 8, "D": 64}),
            (dn, {"entry": "blhd", "S": 300, "H": 16, "KV": 4, "D": 128, "B": 2}),
            (dn, {"entry": "blhd", "S": 150, "H": 8, "KV": 2, "D": 32}),
            (dn, {"entry": "blhd", "S": 70, "H": 4, "KV": 4, "D": 16}),
        ]
    return cases


def _flash_check(fa, dn, case, seed):
    """One flash case against the plain version in f32 on the same inputs."""
    import torch

    dtype = getattr(torch, dn)
    S, H, KV, D, B = case["S"], case["H"], case["KV"], case["D"], case.get("B", 1)
    if case["entry"] == "bhsd":  # (B, H, S, D), no mask, Sq may differ from Sk
        g = torch.Generator(device="cuda").manual_seed(seed)
        q = torch.randn(B, H, S, D, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, KV, case["Sk"], D, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, KV, case["Sk"], D, generator=g, device="cuda").to(dtype)
        got = fa.flash_attention(q, k, v, causal=False)
        want = fa.flash_attention_plain(_f32(q), _f32(k), _f32(v), causal=False)
        pv = fa.flash_attention_plain(_f32(q), _f32(k), _f32(v).abs(), causal=False)
    else:
        if case.get("fused"):  # strided views into one (B, S, H + 2 KV, D) projection
            g = torch.Generator(device="cuda").manual_seed(seed)
            qkv = torch.randn(B, S, H + 2 * KV, D, generator=g, device="cuda").to(dtype)
            q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
        else:
            q, k, v = _flash_inputs(case.get("Sk", S), H, KV, D, dtype, seed=seed, B=B)
            q = q[:, -S:]  # Sk > S: the last S rows' queries, bottom-right causal
        got = fa.flash_causal_attention_blhd(q, k, v)
        want = fa._attention_blhd_plain(_f32(q), _f32(k), _f32(v), True)
        pv = fa._attention_blhd_plain(_f32(q), _f32(k), _f32(v).abs(), True)
    if dn == "float32":
        return compare("flash_attention", got, want, F32_TOL, dtype=dn, **case)
    return compare("flash_attention", got, want, BF16_TOL, P_ROUNDING[dn] * pv, dtype=dn, **case)


def _paged_cases():
    """(dtype name, case) for every paged check: llama3-1b heads (H=32,
    KV=8, D=64) over 16-row pages unless ``case`` names another head dim
    (``D``, 128 is llama3-8b's) or page size (``BS``)."""
    boundary = [15, 16, 17, 31, 32, 0, 1, 47]  # on and off 16-row page edges
    mixed = [0, 3, 40, 300, 1000, 2040, 17, 2000]  # short slots leave later splits empty
    idle = [-1, 500, -1, 1000, 7, -1, 31, 2000]  # -1: an inactive slot sees nothing
    cases = []
    for dn in ("bfloat16", "float32"):  # llama3-8b's head dim
        cases += [
            (dn, {"L": 1, "WB": 64, "D": 128}),
            (dn, {"L": 3, "WB": 128, "D": 128, "pos": mixed}),
            (dn, {"L": 1, "WB": 64, "D": 128, "quant": True}),
            (dn, {"L": 1, "WB": 128, "D": 128, "pos": idle}),
        ]
    for BS, WB in ((32, 64), (8, 256)):  # other page sizes at D=64
        cases += [
            ("bfloat16", {"L": 1, "WB": WB, "BS": BS, "pos": mixed}),
            ("bfloat16", {"L": 2, "WB": 4, "BS": BS,
                          "pos": [BS - 1, BS, BS + 1, 2 * BS - 1, 2 * BS, 0, 1, 3 * BS - 1]}),
            ("bfloat16", {"L": 3, "WB": WB, "BS": BS, "pos": mixed, "quant": True}),
            ("float16", {"L": 1, "WB": WB, "BS": BS, "quant": True}),
            ("bfloat16", {"L": 1, "WB": WB, "BS": BS, "pos": idle}),
            ("float32", {"L": 2, "WB": WB, "BS": BS, "pos": [p if p >= 0 else -3 for p in idle]}),
        ]
    for dn in ("bfloat16", "float32", "float16"):
        cases += [(dn, {"L": L, "WB": 64}) for L in ((1, 2, 3, 4) if dn == "bfloat16" else (1, 3))]
        cases += [
            (dn, {"L": 1, "WB": 64, "quant": True}),
            (dn, {"L": 3, "WB": 64, "quant": True}),
            (dn, {"L": 1, "WB": 64, "pos": [0] * 8}),
            (dn, {"L": 2, "WB": 8, "pos": boundary}),
            (dn, {"L": 1, "WB": 2}),  # a window of 2 pages: one split
            (dn, {"L": 1, "WB": 128, "pos": mixed}),
            (dn, {"L": 4, "WB": 128, "pos": mixed, "quant": True}),
            (dn, {"L": 1, "WB": 128, "pos": idle}),
            (dn, {"L": 3, "WB": 128, "pos": [p if p >= 0 else -2 for p in idle]}),
        ]
    return cases


def phase_kernel_check() -> dict:
    """Every kernel against its plain version, run in f32 on the kernel's
    own inputs; returns the bf16 main-path errors for the kernels line."""
    import torch

    # the submodules (the package re-exports functions of the same names)
    fa = importlib.import_module("seldon_core_tpu_torch.ops.flash_attention")
    pa = importlib.import_module("seldon_core_tpu_torch.ops.paged_attention")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = []
    main_err = {}
    for i, (dn, case) in enumerate(_flash_cases()):
        rec = _flash_check(fa, dn, case, seed=i)
        checks.append(rec)
        if dn == "bfloat16" and case == {"entry": "blhd", "S": 1024, "H": 32, "KV": 8, "D": 64}:
            main_err["flash_attention"] = rec["max_abs_err"]
    H, KV = 32, 8
    for i, (dn, case) in enumerate(_paged_cases()):
        dtype = getattr(torch, dn)
        WB, L, D, BS = case["WB"], case["L"], case.get("D", 64), case.get("BS", 16)
        args, kw = _paged_inputs(8, L, H, KV, D, BS, 1 + 8 * WB, WB, dtype, seed=1000 + i,
                                 quant=case.get("quant", False), pos=case.get("pos"))
        got = pa.paged_decode_attention(*args, **kw)
        want = pa.paged_decode_attention_plain(
            *map(_f32, args), **{n: _f32(x) for n, x in kw.items()})
        splits, per = pa.plan_splits(WB)
        rec = compare("paged_decode_attention", got, want, F32_TOL if dn == "float32" else BF16_TOL,
                      S=8, H=H, KV=KV, splits=splits, per=per, dtype=dn,
                      **{"D": D, "BS": BS, **case})
        checks.append(rec)
        if dn == "bfloat16" and case == {"L": 1, "WB": 64}:
            main_err["paged_decode_attention"] = rec["max_abs_err"]
    # a slot's result must not follow the window width (which follows the
    # batch's longest slot): the same pages under a 64- and a 128-entry
    # window give the same bits
    args, _ = _paged_inputs(8, 1, H, KV, 64, 16, 1 + 8 * 128, 128, torch.bfloat16, seed=999,
                            pos=[5, 100, 333, 500, 777, 900, 1000, 1015])
    q, k, v, table, pos = args
    narrow = pa.paged_decode_attention(q, k, v, table[:, :64].contiguous(), pos)
    wide = pa.paged_decode_attention(q, k, v, table, pos)
    if not torch.equal(narrow, wide):
        raise AssertionError("paged attention's result follows the window width")
    checks.append({"kernel": "paged_decode_attention", "window_invariant": True, "WB": [64, 128],
                   "max_abs_err": 0.0, "max_err_over_limit": 0.0})
    # every query j of a verify pass (chunk j of 4 at 4 query heads per KV
    # head) must give the bits of a decode step (L = 1) at pos + j, also
    # where pos + j starts another page or split: greedy speculation
    # equals speculation off on it
    for dn, quant in (("bfloat16", False), ("bfloat16", True), ("float32", False)):
        args, kw = _paged_inputs(8, 1 + SPEC_DRAFT, H, KV, 64, 16, 1 + 8 * 64, 64,
                                 getattr(torch, dn), seed=997, quant=quant,
                                 pos=[125, 126, 127, 13, 300, 511, 0, 1020])
        q, k, v, table, pos = args
        verify = pa.paged_decode_attention(q, k, v, table, pos, **kw)
        for j in range(1 + SPEC_DRAFT):
            one = pa.paged_decode_attention(q[:, j:j + 1].contiguous(), k, v, table,
                                            (pos + j).to(torch.int32), **kw)
            if not torch.equal(one[:, 0], verify[:, j]):
                raise AssertionError(f"paged attention's query {j} at L={1 + SPEC_DRAFT} is not "
                                     f"the L=1 result at pos+{j} ({dn}, int8 pages: {quant})")
        checks.append({"kernel": "paged_decode_attention", "rows_bit_equal": True, "dtype": dn,
                       "quant": quant, "L": [1, 1 + SPEC_DRAFT], "max_abs_err": 0.0,
                       "max_err_over_limit": 0.0})
    # the causal variant's rows are a cold prefill's rows: the suffix rows
    # [P, P + Sq) of a causal call over the whole padded bucket, bit for
    # bit (key tiles from column 0 on both; tiles a row sees nothing of
    # change nothing), in bf16 (wgmma) and f32 (SIMT), with scores as a
    # model makes them too (queries x 6: a row max of tens, whose product
    # with log2(e) * scale rounds)
    for dn, gain in (("bfloat16", 1.0), ("bfloat16", 6.0), ("float32", 1.0), ("float32", 6.0)):
        for P, Sq, bucket in ((512, 80, 1024), (16, 16, 32), (272, 64, 512), (32, 68, 128),
                              (1024, 1024, 2048), (512, 16, 1024)):
            q, k, v = _flash_inputs(bucket, H, KV, 64, getattr(torch, dn), seed=P + Sq)
            q = (q.float() * gain).to(q.dtype)
            cold = fa.flash_causal_attention_blhd(q, k, v)
            suffix = fa.flash_causal_attention_blhd(q[:, P:P + Sq], k[:, :P + Sq], v[:, :P + Sq])
            if not torch.equal(cold[:, P:P + Sq], suffix):
                raise AssertionError(f"flash attention's suffix rows at P={P}, Sq={Sq} are not "
                                     f"the cold prefill's rows over {bucket} ({dn}, q x {gain})")
            checks.append({"kernel": "flash_attention", "suffix_rows_bit_equal": True, "dtype": dn,
                           "q_gain": gain, "P": P, "Sq": Sq, "bucket": bucket,
                           "max_abs_err": 0.0, "max_err_over_limit": 0.0})
    _sync()
    worst = max(checks, key=lambda r: r["max_err_over_limit"])
    # one short entry per case: the shape keys, the largest error, err/limit
    skip = {"kernel", "max_abs_err", "max_rel_err", "max_err_over_limit", "atol", "rtol",
            "p_rounding", "ok"}
    emit({"phase": "kernel_check", "cases": len(checks), "ok": True,
          "max_err_over_limit": worst["max_err_over_limit"], "worst_case": worst,
          "checks": [
              f"{r['kernel']} " + " ".join(f"{k}={v}" for k, v in r.items() if k not in skip)
              + f" err={r['max_abs_err']:.3g} err/limit={r['max_err_over_limit']:.3g}"
              for r in checks]})
    return main_err


def _card_vs_cpu(cfg, params: dict, prompt, device: str, steps: int,
                 kv_dtype: str | None = None) -> dict:
    """Prefill ``prompt`` and run ``steps`` decode steps on the CPU and on
    ``device`` with the same weights, both fed the card's greedy tokens;
    returns the logits of each, each side's greedy tokens and the pools."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models import llama

    n = len(prompt)
    bucket = 16
    while bucket < n:
        bucket *= 2
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :n] = prompt
    row = np.zeros(cfg.max_seq // 16, np.int32)
    row[:10] = np.arange(1, 11)
    caches = {d: llama.init_paged_cache(cfg, 2, 24, 16, dtype=params[d].tok_emb.dtype,
                                        device=d, kv_dtype=kv_dtype)
              for d in ("cpu", device)}
    logits = {}
    for d in ("cpu", device):
        lg, _ = llama.prefill_slot_paged(
            params[d], torch.from_numpy(padded).to(d), n, 0, row, caches[d], cfg
        )
        logits[d] = [lg.float().cpu()]
    toks = {"cpu": [], device: []}
    feed = int(torch.argmax(logits[device][0]))
    active = torch.tensor([True, False])
    for _ in range(steps):
        for d in ("cpu", device):
            lg, _ = llama.decode_slots_paged(
                params[d], torch.tensor([feed, 0], dtype=torch.int32, device=d), caches[d],
                active.to(d), cfg, window=256,
            )
            logits[d].append(lg[0].float().cpu())
            toks[d].append(int(torch.argmax(lg[0])))
        feed = toks[device][-1]  # both devices see the same tokens
    err = max(float((a - b).abs().max()) for a, b in zip(logits["cpu"], logits[device]))
    scale = max(float(a.abs().max()) for a in logits["cpu"])
    first_err = float((logits["cpu"][0] - logits[device][0]).abs().max())
    return {"err": err, "first_err": first_err, "scale": scale,
            "first_scale": float(logits["cpu"][0].abs().max()),
            "greedy_equal": toks["cpu"] == toks[device], "tokens": toks[device][:8],
            "caches": caches}


def _first_and_greedy(model, slot: int, prompt, steps: int = 16):
    """Admit ``prompt`` into ``slot`` of a GenerativeModel and decode
    ``steps`` greedy tokens; returns the first token's logits (the last
    prefill call's, read where the model samples them) and the tokens."""
    import numpy as np

    caught = []
    sample = model._sample_first

    def keep(logits, payload):
        caught.append(logits.float().cpu())
        return sample(logits, payload)

    model._sample_first = keep
    try:
        first = model.admit(slot, np.asarray(prompt, np.int32), 0.0, 0, reserve_tokens=steps + 1)
    finally:
        del model._sample_first
    S = model.n_slots
    active = np.zeros(S, bool)
    active[slot] = True
    cur = np.zeros(S, np.int32)
    cur[slot] = first
    toks, _ = model.step_k(cur, active, np.zeros(S, np.float32), 0, np.full(S, -1, np.int32),
                           np.full(S, steps, np.int32), steps)
    return caught[-1], [first] + toks[:, slot].tolist()


def _reuse_and_chunk_checks(cfg, params, device: str, exact: bool = False,
                            kv_cache_dtype: str | None = None) -> list[dict]:
    """On the card: a prompt whose first 2 blocks are in the prefix index
    against the same prompt cold, and ``prefill_chunk=64`` over a 300-token
    prompt against the monolithic prefill.  Every prefill runs flash
    attention (K1), the suffix prefills its bottom-right causal variant
    over the gathered prefix.  Each check also holds the model's counters
    to what it must have done (one reuse of 32 tokens; five 64-token
    chunks), so that a cold prefill is never compared with a cold prefill.
    ``exact`` gates bit-equal first logits (else a tolerance)."""
    import numpy as np

    from seldon_core_tpu_torch.executor.generation import GenerativeModel

    rng = np.random.default_rng(7)
    prefix = rng.integers(0, cfg.vocab_size, 32).tolist()  # 2 blocks of 16
    prompt = prefix + rng.integers(0, cfg.vocab_size, 68).tolist()  # 100 tokens
    long_prompt = rng.integers(0, cfg.vocab_size, 300).tolist()

    def model(**kw):
        return GenerativeModel(cfg, params, n_slots=2, decode_block=16, device=device,
                               kv_cache_dtype=kv_cache_dtype, **kw)

    out = []
    cold = _first_and_greedy(model(), 1, prompt)
    warm_model = model(prefix_reuse=True)
    warm_model.admit(0, np.asarray(prefix + rng.integers(0, cfg.vocab_size, 9).tolist(),
                                   np.int32), 0.0, 0)
    warm_model.release_slot(0)  # its 2 full blocks go into the index
    warm = _first_and_greedy(warm_model, 1, prompt)
    out.append(("prefix_reuse", cold, warm,
                {"prefills_reused": warm_model.prefills_reused,
                 "tokens_reused": warm_model.prefix_snapshot()["tokens_reused"]},
                {"prefills_reused": 1, "tokens_reused": 32}))
    mono = _first_and_greedy(model(), 1, long_prompt)
    chunk_model = model(prefill_chunk=64)
    chunked = _first_and_greedy(chunk_model, 1, long_prompt)
    out.append(("chunked", mono, chunked, {"prefill_chunks": chunk_model.prefill_chunks},
                {"prefill_chunks": 5}))
    recs = []
    for name, (want_lg, want_toks), (got_lg, got_toks), counts, want_counts in out:
        err = float((want_lg - got_lg).abs().max())
        scale = float(want_lg.abs().max())
        tol = 1e-3 * max(1.0, scale)
        recs.append({"check": name, "kv_cache_dtype": kv_cache_dtype, "first_logit_err": err,
                     "logit_scale": scale, "tol": 0.0 if exact else tol, "bit_equal": err == 0.0,
                     "greedy_equal": want_toks == got_toks, "tokens": got_toks[:8], **counts,
                     "counts_want": want_counts, "counts_ok": counts == want_counts,
                     "prefill_split": sorted(warm_model._prefill_split),
                     "ok": (err == 0.0 if exact else err <= tol) and want_toks == got_toks
                     and counts == want_counts})
    return recs


def phase_reference(device: str = "cuda") -> None:
    """The model at llama3-1b head geometry (2 layers, f32) on ``device``
    against the same weights on the CPU, where the plain versions run:
    prefill logits, then teacher-forced decode logits and greedy tokens,
    over a float pool and an int8 pool; then prefix reuse against a cold
    prefill and chunked against monolithic prefill, on the card."""
    import dataclasses

    import numpy as np
    import torch

    from seldon_core_tpu_torch.models import llama
    from seldon_core_tpu_torch.models.weights import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(llama.Config.llama3_1b(max_seq=256), n_layers=2)
    gen = torch.Generator(device="cpu").manual_seed(1)
    cpu = init_params(cfg, gen, dtype=torch.float32, device="cpu")
    dev = init_params(cfg, torch.Generator(device="cpu").manual_seed(1), device="cpu").to(device)
    params = {"cpu": cpu, device: dev}
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 100).astype(np.int32)
    flt = _card_vs_cpu(cfg, params, prompt, device, 8)
    tol = 1e-3 * max(1.0, flt["scale"])
    rec = {"phase": "reference", "config": "llama3-1b heads, 2 layers, f32",
           "prefill_len": 100, "decode_steps": 8, "max_abs_logit_err": flt["err"],
           "logit_scale": flt["scale"], "tol": tol, "greedy_equal": flt["greedy_equal"]}
    rec["ok"] = flt["err"] <= tol and rec["greedy_equal"]
    q = _card_vs_cpu(cfg, params, prompt, device, 16, kv_dtype="int8")
    qtol = 1e-3 * max(1.0, q["scale"])
    flips, written, worst = 0, 0, 0
    for key in ("k", "v"):
        a, b = (q["caches"][d][key].cpu().int() for d in ("cpu", device))
        flips += int((a != b).sum())
        worst = max(worst, int((a - b).abs().max()))
        written += int((a != 0).sum())
    scale_err = max(float((q["caches"]["cpu"][k] - q["caches"][device][k].cpu()).abs().max())
                    for k in ("k_scale", "v_scale"))
    rec["int8"] = {
        "prefill_len": 100, "decode_steps": 16, "max_abs_logit_err": q["err"],
        "logit_scale": q["scale"], "tol": qtol, "greedy_equal": q["greedy_equal"],
        "bytes_written": written, "bytes_differing": flips, "max_byte_diff": worst,
        "tie_share_limit": INT8_TIE_SHARE, "max_abs_scale_err": scale_err,
        "ok": (q["err"] <= qtol and q["greedy_equal"] and worst <= 1
               and flips <= INT8_TIE_SHARE * written),
    }
    rcfg = dataclasses.replace(cfg, max_seq=512)
    rec["card_only"] = _reuse_and_chunk_checks(rcfg, dev, device)
    rec["ok"] = rec["ok"] and rec["int8"]["ok"] and all(r["ok"] for r in rec["card_only"])
    # the same in bf16 (the served dtype), float and int8 pools, gated bit
    # for bit: the suffix prefill runs K1's variant over the gathered prefix
    # and every prefill runs the row-variant ops in the same row tiles
    bf16 = init_params(cfg, torch.Generator(device="cpu").manual_seed(1), device="cpu").to(
        device=device, dtype=torch.bfloat16)
    rec["card_only_bf16"] = [r for kv in (None, "int8") for r in _reuse_and_chunk_checks(
        rcfg, bf16, device, exact=True, kv_cache_dtype=kv)]
    rec["ok"] = rec["ok"] and all(r["ok"] for r in rec["card_only_bf16"])
    del bf16
    rec["spec"] = _spec_reference(cfg, cpu, dev, device)
    rec["ok"] = rec["ok"] and all(r["ok"] for r in rec["spec"])
    del cpu, dev, params
    rec["llama3_8b"] = _reference_8b(device)
    rec["ok"] = rec["ok"] and rec["llama3_8b"]["ok"]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("the model on the card disagrees with its reference")


def _f32_on_cpu(params):
    """A copy of ``params`` (a ``Llama`` on any device, any float type) in
    f32 on the CPU; the original is left as it is."""
    import torch

    from seldon_core_tpu_torch.models import llama

    tensors = {k: getattr(params, k).detach().to("cpu", torch.float32)
               for k in ("tok_emb", "ln_f", "head")}
    tensors.update({f"layers/{k}": params.layers[k].detach().to("cpu", torch.float32)
                    for k in llama.LAYER_KEYS})
    return llama.Llama(params.cfg, tensors)


def _reference_8b(device: str) -> dict:
    """The llama3-8b geometry at 2 of its 32 layers (a depth cut): bf16
    weights made on the card from a seed, run there in bf16 and on the
    CPU in f32 (the same values), teacher-forced with the card's greedy
    tokens for 8 steps."""
    import dataclasses

    import numpy as np
    import torch

    from seldon_core_tpu_torch.models import llama
    from seldon_core_tpu_torch.models.weights import init_params

    cfg = dataclasses.replace(llama.Config.llama3_8b(), n_layers=2, max_seq=256)
    card = init_params(cfg, torch.Generator(device=device).manual_seed(2), dtype=torch.bfloat16,
                       device=device)
    params = {"cpu": _f32_on_cpu(card), device: card}
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 100).astype(np.int32)
    res = _card_vs_cpu(cfg, params, prompt, device, 8)
    tol = REF_BF16_TOL * max(1.0, res["first_scale"])
    return {"config": "llama3-8b geometry, 2 of 32 layers, card bf16 vs CPU f32",
            "hidden": cfg.hidden, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim, "vocab": cfg.vocab_size, "prefill_len": int(prompt.size),
            "first_logit_err": res["first_err"], "first_logit_scale": res["first_scale"],
            "tol": tol, "max_logit_err_8_steps": res["err"],
            "greedy_equal_reported": res["greedy_equal"], "tokens": res["tokens"],
            "ok": res["first_err"] <= tol}


def _streams(model, prompts, max_new: int) -> list[list[int]]:
    """Greedy streams of ``prompts``, submitted together to a scheduler
    over ``model``."""
    import numpy as np

    from seldon_core_tpu_torch.executor.generation import GenerationScheduler

    sched = GenerationScheduler(model)

    async def go():
        try:
            return await asyncio.gather(*(
                sched.submit(np.asarray(p, np.int32), max_new_tokens=max_new) for p in prompts))
        finally:
            await sched.close()

    return [o.tolist() for o in asyncio.run(go())]


def _spec_reference(cfg, cpu, dev, device: str) -> list[dict]:
    """Speculative decoding (``spec_draft=3``) with each proposer, f32:
    greedy streams on the card against speculation off on the card and
    against speculation on on the CPU.  The heads are made once on the CPU
    from the ``lm_head`` and carried to both devices."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.executor.generation import GenerativeModel
    from seldon_core_tpu_torch.models import llama

    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, 100).tolist(),
               np.tile(rng.integers(0, cfg.vocab_size, REPEAT_CYCLE),
                       REPEAT_LEN // REPEAT_CYCLE).tolist()]
    max_new = 24
    heads = llama.init_medusa_heads(torch.Generator().manual_seed(2), cfg, SPEC_DRAFT,
                                    base_head=cpu.head)
    methods = {"ngram": {}, "heads": {"spec_method": "heads", "medusa_heads": heads},
               "draft": {"spec_method": "draft", "spec_draft_model": "truncate:1"}}

    def model(params, d, **kw):
        return GenerativeModel(cfg, params, n_slots=2, decode_block=16, device=d, **kw)

    off = _streams(model(dev, device), prompts, max_new)
    recs = []
    for name, kw in methods.items():
        on_model = model(dev, device, spec_draft=SPEC_DRAFT, **kw)
        on = _streams(on_model, prompts, max_new)
        on_cpu = _streams(model(cpu, "cpu", spec_draft=SPEC_DRAFT, **kw), prompts, max_new)
        snap = on_model.spec_snapshot()
        recs.append({
            "method": name, "spec_draft": SPEC_DRAFT, "prompt_lens": [len(p) for p in prompts],
            "max_new_tokens": max_new, "equal_spec_off_card": on == off,
            "equal_spec_on_cpu": on == on_cpu, "tokens": [o[:8] for o in on],
            "spec_verify_passes": snap["spec_verify_passes"],
            "spec_emitted_tokens": snap["spec_emitted_tokens"],
            "accepted_tokens_per_step": snap["accepted_tokens_per_step"],
            "ok": (on == off and on == on_cpu and snap["spec_verify_passes"] > 0
                   and snap["spec_emitted_tokens"] >= snap["spec_verify_passes"]),
        })
    return recs


GRAPH_LAYERS = 2  # the graphs phase cuts llama3-1b's depth: replay vs eager is per layer


def _device_state(model) -> dict:
    """Every device tensor a decode block may write: the pool (pages,
    scales, positions, tables), the speculation state, the draft pool."""
    state = {f"cache.{k}": v for k, v in model._cache.items()}
    for name in ("_hist", "_hlast"):
        if getattr(model, name) is not None:
            state[name] = getattr(model, name)
    if model._draft_cache is not None:
        state.update({f"draft.{k}": v for k, v in model._draft_cache.items()})
    return state


def _replay_vs_eager(model, prompts, temperature: float, adapters=None) -> dict:
    """Admit ``prompts`` into ``model``'s slots (through ``adapters`` when
    given), then run one block eagerly (the eager yardstick) and, from the
    same state, one block replayed from its CUDA graph (captured first when
    it is not yet): tokens, mask and every pool byte must be equal, the
    replay must count the launches the eager block made, and no graph may
    be captured between the two.  ``captures`` is the model's count after."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.ops import _build

    S, k = model.n_slots, model.decode_block
    cur = _admit_all(model, prompts, k * model._tps + 1, temperature, adapters)
    active = np.arange(S) < len(prompts)
    args = (cur, active, np.full(S, temperature, np.float32), 1234, np.full(S, -1, np.int32),
            np.full(S, 1000, np.int32), k)
    before = {n: t.clone() for n, t in _device_state(model).items()}
    ceiling = model._pos_ceiling.copy()

    def restore():
        for n, t in _device_state(model).items():
            t.copy_(before[n])
        model._pos_ceiling[:] = ceiling

    # capture first (its warm-up run writes the sink block), then both
    # blocks from the same state
    with torch.no_grad():
        model._graph(k, model._window_for(active, k * model._tps))
    compiles = model.program_compiles
    restore()
    model._eager_on_card = True
    _build.reset_launches()
    eager = model.step_k(*args)
    eager_launches = dict(_build.LAUNCHES)
    eager_state = {n: t.clone() for n, t in _device_state(model).items()}
    model._eager_on_card = False
    restore()
    _build.reset_launches()
    replay = model.step_k(*args)
    replay_launches = dict(_build.LAUNCHES)
    _sync()
    differ = [n for n, t in _device_state(model).items() if not torch.equal(t, eager_state[n])]
    ok = (bool(np.array_equal(eager[0], replay[0])) and bool(np.array_equal(eager[1], replay[1]))
          and not differ and eager_launches == replay_launches
          and model.program_compiles == compiles)
    return {"tokens_equal": bool(np.array_equal(eager[0], replay[0])),
            "mask_equal": bool(np.array_equal(eager[1], replay[1])),
            "state_differs": differ, "tokens_emitted": int(eager[1].sum()),
            "captures": model.program_compiles, "launches_eager": eager_launches,
            "launches_replay": replay_launches, "ok": ok}


def phase_graphs(device: str = "cuda", preset: str = SERVE_PRESET) -> None:
    """A decode block replayed from its CUDA graph against the same block
    run eagerly on the card, from the same state, bit for bit (tokens,
    emitted mask, every pool byte), at llama3-1b width cut to GRAPH_LAYERS
    layers, bf16, 8 slots, 16-step blocks: a float pool (greedy, sampled,
    sampled with top_k), an int8 pool, and each proposer at
    ``spec_draft=3`` (greedy, and ``ngram`` sampled)."""
    import dataclasses

    import numpy as np
    import torch

    from seldon_core_tpu_torch.executor.generation import GenerativeModel
    from seldon_core_tpu_torch.models.registry import resolve_config
    from seldon_core_tpu_torch.models.weights import init_params

    cfg = dataclasses.replace(resolve_config(preset), n_layers=GRAPH_LAYERS)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         dtype=torch.bfloat16, device=device)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in SERVE_LENGTHS]
    cases = {
        "float_greedy": ({}, 0.0), "float_sampled": ({}, 0.8),
        "float_sampled_top_k": ({"top_k": 40}, 0.8),
        "int8_greedy": ({"kv_cache_dtype": "int8"}, 0.0),
        "int8_sampled": ({"kv_cache_dtype": "int8"}, 0.8),
        "ngram_greedy": ({"spec_draft": SPEC_DRAFT}, 0.0),
        "ngram_sampled": ({"spec_draft": SPEC_DRAFT}, 0.8),
        "heads_greedy": ({"spec_draft": SPEC_DRAFT, "spec_method": "heads"}, 0.0),
        "draft_greedy": ({"spec_draft": SPEC_DRAFT, "spec_method": "draft",
                          "spec_draft_model": "truncate:1"}, 0.0),
    }
    recs = {}
    for name, (kw, temperature) in cases.items():
        model = GenerativeModel(cfg, params, n_slots=SERVE_SLOTS, decode_block=SERVE_BLOCK,
                                device=device, **kw)
        recs[name] = {"temperature": temperature, **kw,
                      **_replay_vs_eager(model, prompts, temperature)}
        recs[name]["ok"] = recs[name]["ok"] and recs[name]["captures"] == 1
        recs[name]["program"] = {key: v for key, v in model.program_snapshot().items()
                                 if key != "graphs"}
        recs[name]["graph"] = model.program_snapshot()["graphs"][0]
        del model
        torch.cuda.empty_cache()
    rec = {"phase": "graphs", "preset": preset, "layers": GRAPH_LAYERS, "dtype": "bfloat16",
           "n_slots": SERVE_SLOTS, "decode_block": SERVE_BLOCK,
           "prompt_lens": [len(p) for p in prompts], "cases": recs,
           "ok": all(r["ok"] for r in recs.values())}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("graphs: a replayed block is not the eager block bit for bit")


def _post(port: int, body: dict, timeout: float = 600.0) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v0.1/predictions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _req(port: int, body, headers: dict | None = None,
         path: str = "/api/v0.1/predictions", timeout: float = 600.0) -> dict:
    """POST ``body`` (bytes, or a dict as JSON) -> its status, headers
    (lower case), raw body, send time and wall seconds (encoding included)."""
    sent = time.perf_counter()
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, hdrs, raw = resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        status, hdrs, raw = e.code, e.headers, e.read()
    return {"status": status, "headers": {k.lower(): v for k, v in hdrs.items()},
            "raw": raw, "sent": sent, "s": time.perf_counter() - sent}


def _call(port: int, path: str, body, headers: dict | None = None,
          timeout: float = 600.0) -> tuple[int, bytes]:
    """POST ``body`` (a dict as JSON, or bytes) to ``path`` -> (status, body)."""
    r = _req(port, body, headers, path, timeout)
    return r["status"], r["raw"]


async def _requests(port: int, bodies, headers=None) -> list[dict]:
    """``bodies`` posted concurrently (``headers``: one dict a body, or None)
    -> :func:`_req`'s replies."""
    loop = asyncio.get_running_loop()
    headers = headers or [None] * len(bodies)
    with concurrent.futures.ThreadPoolExecutor(len(bodies)) as clients:
        return list(await asyncio.gather(*(loop.run_in_executor(clients, _req, port, b, h)
                                           for b, h in zip(bodies, headers))))


def _get(port: int, path: str) -> int:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def _fetched_steps(model, blocks_before: int) -> int:
    """The steps (verify passes with speculation) of the decode blocks
    fetched since the count was ``blocks_before``: the step time of a
    wave is the fetched blocks' device seconds over these.  (The model's
    ``steps`` counts a block at dispatch, and the overlap dispatches one
    block more than a wave needs before its last fetch, whose seconds
    land only when it is fetched.)"""
    return (model.decode_blocks - blocks_before) * model.decode_block


def phase_serve(device: str = "cuda", preset: str = SERVE_PRESET,
                lengths=SERVE_LENGTHS, seed: int = 0) -> dict:
    """Boot the engine in-process and answer concurrent strData requests over
    HTTP; returns what the kernel lines need (launch counts, main-path
    shapes)."""
    import numpy as np

    from seldon_core_tpu_torch.ops import _build

    spec = _serve_spec(preset, seed)
    rng = np.random.default_rng(seed)

    async def run() -> dict:
        app, boot_s = await _boot(spec, device)
        port = app.port
        try:
            model = app.service.walker.component.model
            vocab = model.cfg.vocab_size
            prompts = [VERIFY_PROMPT] + [
                rng.integers(0, vocab, n).tolist() for n in lengths if n != len(VERIFY_PROMPT)
            ]
            prompts.append(prompts[3])  # a repeat inside the concurrent wave
            sched = app.service.walker.component.scheduler
            warm = model.program_snapshot()
            _build.reset_launches()  # the main path's run starts here
            model_before = (model.decode_blocks, model.host_syncs, model.overlapped,
                            model.steps, model.block_seconds)
            replies, wave_s = await _serve_wave(port, prompts)
            again = await asyncio.to_thread(_post, port, {"strData": json.dumps(
                {"tokens": VERIFY_PROMPT, "max_new_tokens": MAX_NEW})})
            launches = dict(_build.LAUNCHES)
            blocks = model.decode_blocks - model_before[0]
            syncs = model.host_syncs - model_before[1]
            overlapped = model.overlapped - model_before[2]
            step_ms = 1e3 * (model.block_seconds - model_before[4]) / max(
                1, _fetched_steps(model, model_before[0]))
            breaks = dict(sched.overlap_breaks)
            served = model.program_snapshot()
            # the same wave with the overlap off, then on the eager loop
            # (the yardstick), then as served again (the first wave's
            # order effects): greedy streams must not move
            yardsticks = {}
            for name, overlap, eager in (("overlap_off", False, False),
                                         ("eager", False, True), ("overlap_again", True, False)):
                sched.overlap, model._eager_on_card = overlap, eager
                before = (model.decode_blocks, model.block_seconds, len(sched.ttft))
                yard, yard_s = await _serve_wave(port, prompts)
                yard_ttft = sorted(t for _, t in list(sched.ttft)[before[2]:])
                yardsticks[name] = {
                    "outs": _check_replies(yard, prompts, model.cfg.vocab_size),
                    "wave_s": yard_s, "wave_tokens_per_s": len(prompts) * MAX_NEW / yard_s,
                    "ttft_s_p50": yard_ttft[len(yard_ttft) // 2],
                    "decode_step_ms": 1e3 * (model.block_seconds - before[1])
                    / max(1, _fetched_steps(model, before[0]))}
            sched.overlap, model._eager_on_card = True, False
            tiles = _prefill_tile_cost(model)
            outs = []
            for (status, body), p in zip(replies + [again], prompts + [VERIFY_PROMPT]):
                toks = json.loads(body["strData"])["tokens"]
                if status != 200 or body["status"]["code"] != 200:
                    raise AssertionError(f"request failed: {body}")
                if len(toks) != MAX_NEW or not all(0 <= t < vocab for t in toks):
                    raise AssertionError(f"bad reply for a {len(p)}-token prompt: {toks}")
                outs.append(toks)
            if outs[-1] != outs[0] or outs[len(prompts) - 1] != outs[3]:
                raise AssertionError("a repeated greedy prompt gave other tokens")
            missing = [k for k, n in launches.items() if n == 0]
            if missing:
                raise AssertionError(f"the served path never launched {missing}")
            ttft = sorted(t for _, t in list(sched.ttft)[:len(prompts) + 1])
            equal = {name: _streams_equal(outs[:len(prompts)], y.pop("outs"))
                     for name, y in yardsticks.items()}
            buckets = len(model._window_buckets())
            rec = {
                "phase": "serve", "preset": preset, "dtype": "bfloat16",
                "n_slots": SERVE_SLOTS, "decode_block": SERVE_BLOCK,
                "requests": len(prompts) + 1, "concurrent": len(prompts),
                "prompt_lens": [len(p) for p in prompts], "max_new_tokens": MAX_NEW,
                "boot_and_warmup_s": boot_s, "wave_s": wave_s,
                "ttft_s_p50": ttft[len(ttft) // 2], "ttft_s_max": ttft[-1],
                # end to end: every token the wave generated over its wall time
                "wave_tokens_per_s": len(prompts) * MAX_NEW / wave_s,
                # a step: the device time of the blocks (one replay each)
                # over their steps
                "decode_step_ms": step_ms,
                "decode_blocks": blocks, "host_syncs": syncs,
                "host_syncs_per_block": syncs / max(1, blocks),
                "overlapped": overlapped, "overlap_breaks": breaks,
                "program_compiles_after_warmup": warm["program_compiles"],
                "program_compiles_after_serving": served["program_compiles"],
                "window_buckets": buckets, "program_hits": served["program_hits"],
                "graphs": warm["graphs"],
                "streams_equal": equal, "yardsticks": yardsticks, "prefill_tiles": tiles,
                "launches": launches, "verify_prompt_tokens": outs[0][:8],
                # the decode contract: one host sync per decode block, blocks
                # continued off the carry, every block a replay of a graph
                # captured at warmup, the streams of the overlap off and of
                # the eager loop
                "ok": (blocks > 0 and syncs == blocks and overlapped >= 1
                       and warm["program_compiles"] == served["program_compiles"] == buckets
                       and all(n == len(prompts) for n in equal.values())),
            }
            emit(rec)
            if not rec["ok"]:
                raise AssertionError(
                    f"serve: {syncs} host syncs over {blocks} decode blocks, {overlapped} "
                    "continued, captures after warmup or streams against overlap off and "
                    "the eager loop (see the record)")
            rec["pos"] = [min(len(p) + MAX_NEW // 2, model.cfg.max_seq - 1)
                          for p in prompts[:SERVE_SLOTS]]
            rec["bucket"] = model.fit_bucket(max(lengths))
            # the distinct prompts and their streams, for serve_spec
            rec["prompts"], rec["outs"] = prompts[:-1], outs[:len(prompts) - 1]
            return rec
        finally:
            await app.close()

    return asyncio.run(run())


async def _serve_wave(port: int, prompts) -> tuple[list, float]:
    """``prompts`` posted concurrently -> (replies, wave seconds)."""
    loop = asyncio.get_running_loop()
    t1 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as clients:
        replies = await asyncio.gather(*(
            loop.run_in_executor(clients, _post, port, {"strData": json.dumps(
                {"tokens": p, "max_new_tokens": MAX_NEW})})
            for p in prompts
        ))
    return replies, time.perf_counter() - t1


def _prefill_tile_cost(model, buckets=(256, 1024, 2048), iters: int = 3) -> dict:
    """A cold prefill's device ms (CUDA events, the host's enqueue
    included) at each bucket with the model's row-tiled ops
    (``_prefill_split`` in ``llama.PREFILL_ROW_TILE``-row tiles) and with
    every op in one call, into a scratch pool."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models import llama

    cfg = model.cfg
    cache = llama.init_paged_cache(cfg, 1, 1 + cfg.max_seq // 16, 16, dtype=model.dtype,
                                   device=model.device)
    row = np.arange(1, 1 + cfg.max_seq // 16, dtype=np.int32)
    out = {"ops": sorted(model._prefill_split), "tile_rows": llama.PREFILL_ROW_TILE}
    for b in buckets:
        toks = torch.from_numpy(np.random.default_rng(b).integers(
            0, cfg.vocab_size, (1, b)).astype(np.int32)).to(model.device)
        for name, op in (("tiled_ms", model._prefill_op), ("one_call_ms", llama._plain)):
            times = []
            for _ in range(iters + 1):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                llama.prefill_slot_paged(model.params, toks, b, 0, row, cache, cfg, op=op)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            out.setdefault(str(b), {})[name] = statistics.median(times[1:])
    return out


def _serve_spec_dict(preset: str, seed: int, name: str = "smoke", **extra) -> dict:
    """The smoke's ``JAX_GENERATIVE`` predictor as a dict: llama ``preset``
    in bf16 with seeded weights, 8 slots, 16-step blocks, 32 new tokens;
    ``extra`` adds graph parameters (name -> (value, type))."""
    params = {"family": ("llama", "STRING"), "preset": (preset, "STRING"),
              "dtype": ("bfloat16", "STRING"), "n_slots": (SERVE_SLOTS, "INT"),
              "decode_block": (SERVE_BLOCK, "INT"), "max_new_tokens": (MAX_NEW, "INT"),
              "rng": (seed, "INT"), **extra}
    return {
        "name": name,
        "graph": {
            "name": "gen", "type": "MODEL", "implementation": "JAX_GENERATIVE",
            "parameters": [{"name": k, "value": str(v), "type": t}
                           for k, (v, t) in params.items()],
        },
    }


def _serve_spec(preset: str, seed: int, name: str = "smoke", **extra):
    """:func:`_serve_spec_dict` as a ``PredictorSpec``."""
    from seldon_core_tpu_torch.graph.spec import PredictorSpec

    return PredictorSpec.from_dict(_serve_spec_dict(preset, seed, name, **extra))


async def _boot(spec, device: str, port: int = 0, grpc_port: int | None = None, **engine):
    """Start the engine (``engine``: its role and decode peers) on ``port``
    (0: a free one), with its gRPC service on ``grpc_port`` when given, and
    wait until it is ready (warmup included); returns the app and the
    seconds that took."""
    from seldon_core_tpu_torch.engine.app import EngineApp
    from seldon_core_tpu_torch.engine.service import PredictionService

    app = EngineApp(PredictionService(spec, device=device), **engine)
    await app.start("127.0.0.1", port, grpc_port=grpc_port)
    t0 = time.perf_counter()
    boot = asyncio.create_task(app.boot())
    try:
        while await asyncio.to_thread(_get, app.port, "/ready") != 200:
            if boot.done():
                boot.result()  # raises the boot failure
            await asyncio.sleep(0.2)
    except BaseException:
        boot.cancel()
        await app.close()
        raise
    await boot
    return app, time.perf_counter() - t0


def _check_replies(replies, prompts, vocab: int, max_new=MAX_NEW) -> list[list[int]]:
    """Each reply 200 with ``max_new`` (an int, or one per prompt) valid
    token ids; returns the token lists."""
    outs = []
    news = max_new if isinstance(max_new, (list, tuple)) else [max_new] * len(prompts)
    for (status, body), p, n in zip(replies, prompts, news):
        if status != 200 or body["status"]["code"] != 200:
            raise AssertionError(f"request failed: {body}")
        toks = json.loads(body["strData"])["tokens"]
        if len(toks) != n or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"bad reply for a {len(p)}-token prompt: {toks}")
        outs.append(toks)
    return outs


def _record_blocks(model) -> list:
    """Log, on ``model``'s instance, each decode block (with its seconds)
    and each admission and paced chunk dispatched before it."""
    events = []
    fetch, admit, chunk = model.step_k_fetch, model.admit_dispatch, model.prefill_chunk_dispatch

    def logged_step(*a, **kw):  # at the block's fetch: its seconds on the card
        out = fetch(*a, **kw)
        events.append(("block", model.last_block_s))
        return out

    def logged_admit(*a, **kw):
        events.append(("admit", None))
        return admit(*a, **kw)

    def logged_chunk(*a, **kw):
        t0 = time.perf_counter()
        out = chunk(*a, **kw)
        events.append(("chunk", time.perf_counter() - t0))  # host time, no sync
        return out

    model.step_k_fetch, model.admit_dispatch, model.prefill_chunk_dispatch = (
        logged_step, logged_admit, logged_chunk)
    return events


def _block_times(events) -> dict:
    """Mean decode-block milliseconds after nothing else was dispatched since
    the previous block, and after exactly one paced chunk (and no
    admission); and the host's mean time to dispatch a chunk."""
    clean, after_chunk, since = [], [], []
    chunk_s = [sec for kind, sec in events if kind == "chunk"]
    for kind, sec in events:
        if kind != "block":
            since.append(kind)
            continue
        if not since:
            clean.append(sec)
        elif since == ["chunk"]:
            after_chunk.append(sec)
        since = []

    def mean(xs):
        return sum(xs) / len(xs) if xs else None

    return {"blocks_clean": len(clean), "block_ms_clean": 1e3 * mean(clean) if clean else None,
            "blocks_after_chunk": len(after_chunk),
            "block_ms_after_chunk": 1e3 * mean(after_chunk) if after_chunk else None,
            "chunk_dispatch_ms": 1e3 * mean(chunk_s) if chunk_s else None}


def phase_serve_cached(device: str = "cuda", preset: str = SERVE_PRESET, seed: int = 1) -> dict:
    """The serve graph with int8 KV, prefix reuse and chunked prefill: a warm
    request, then six prompts sharing its 512-token prefix and, while they
    decode, two long unshared ones.  Returns the kernels' launch counts."""
    import numpy as np

    from seldon_core_tpu_torch.models import llama
    from seldon_core_tpu_torch.ops import _build

    spec = _serve_spec(preset, seed, kv_cache_dtype=("int8", "STRING"),
                       kv_prefix_reuse=("true", "BOOL"), prefill_chunk=(CACHED_CHUNK, "INT"))
    rng = np.random.default_rng(seed)

    async def run() -> dict:
        app, boot_s = await _boot(spec, device)
        port = app.port
        try:
            comp = app.service.walker.component
            model, sched = comp.model, comp.scheduler
            vocab = model.cfg.vocab_size
            prefix = rng.integers(0, vocab, CACHED_PREFIX).tolist()
            warm = prefix + rng.integers(0, vocab, 24).tolist()
            shared = [prefix + rng.integers(0, vocab, n).tolist() for n in SHARED_SUFFIXES]
            longs = [rng.integers(0, vocab, n).tolist() for n in LONG_LENGTHS]

            def body(p, max_new=MAX_NEW):
                return {"strData": json.dumps({"tokens": p, "max_new_tokens": max_new})}

            news = [SHARED_NEW] * len(shared) + [MAX_NEW] * len(longs)
            _check_replies([await asyncio.to_thread(_post, port, body(warm))], [warm], vocab)
            events = _record_blocks(model)
            # the long prompts arrive once the shared streams' first block
            # is delivered: they decode then, so the chunks are paced
            decoding = asyncio.Event()
            deliver = sched._deliver

            def delivered(*a, **kw):
                deliver(*a, **kw)
                decoding.set()

            sched._deliver = delivered
            # K1 launches and host seconds of the suffix prefills (reused
            # prefixes and every chunk after the first)
            suffix = {"flash_launches": 0, "host_s": []}
            exec_suffix = model._exec_prefill_suffix

            def counted_suffix(payload):
                k1, t0 = _build.LAUNCHES["flash_attention"], time.perf_counter()
                out = exec_suffix(payload)
                suffix["host_s"].append(time.perf_counter() - t0)
                suffix["flash_launches"] += _build.LAUNCHES["flash_attention"] - k1
                return out

            model._exec_prefill_suffix = counted_suffix
            _build.reset_launches()  # this phase's run starts here
            before = {
                "blocks": model.decode_blocks, "syncs": model.host_syncs,
                "block_s": model.block_seconds, "reused": model.prefills_reused,
                "tokens_reused": model.prefix_snapshot()["tokens_reused"],
                "paced": sched.chunks_paced, "chunks": model.prefill_chunks,
                "ttft": len(sched.ttft),
            }
            loop = asyncio.get_running_loop()
            t1 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(len(shared) + len(longs)) as clients:
                first = [loop.run_in_executor(clients, _post, port, body(p, SHARED_NEW))
                         for p in shared]
                await asyncio.wait_for(decoding.wait(), 600)
                late = [loop.run_in_executor(clients, _post, port, body(p)) for p in longs]
                replies = await asyncio.gather(*first, *late)
            wave_s = time.perf_counter() - t1
            launches = dict(_build.LAUNCHES)
            outs = _check_replies(replies, shared + longs, vocab, news)
            del model._exec_prefill_suffix, sched._deliver
            snap = model.prefix_snapshot()
            blocks = model.decode_blocks - before["blocks"]
            syncs = model.host_syncs - before["syncs"]
            steps = _fetched_steps(model, before["blocks"])
            ttft = list(sched.ttft)[before["ttft"]:]
            t_shared = sorted(t for n, t in ttft if n < min(LONG_LENGTHS))
            t_long = sorted(t for n, t in ttft if n >= min(LONG_LENGTHS))
            missing = [k for k, n in launches.items() if n == 0]
            rec = {
                "phase": "serve_cached", "preset": preset, "dtype": "bfloat16",
                "kv_cache_dtype": model.kv_dtype, "prefill_chunk": model.prefill_chunk,
                "kv_prefix_reuse": model.prefix_index is not None, "n_slots": SERVE_SLOTS,
                "decode_block": SERVE_BLOCK, "max_new_tokens": MAX_NEW,
                "prompt_lens": [len(p) for p in shared + longs], "warm_prompt_len": len(warm),
                "max_new_tokens_each": news, "boot_and_warmup_s": boot_s, "wave_s": wave_s,
                "ttft_s_shared_p50": statistics.median(t_shared), "ttft_s_shared_max": t_shared[-1],
                "ttft_s_long_p50": statistics.median(t_long), "ttft_s_long_max": t_long[-1],
                "ttft_s_long": t_long,
                "wave_tokens_per_s": sum(news) / wave_s,
                "decode_step_ms": 1e3 * (model.block_seconds - before["block_s"]) / max(1, steps),
                **_block_times(events),
                "prefills_reused": model.prefills_reused - before["reused"],
                "tokens_reused": snap["tokens_reused"] - before["tokens_reused"],
                "prefill_chunks": model.prefill_chunks - before["chunks"],
                "chunks_paced": sched.chunks_paced - before["paced"],
                "decode_blocks": blocks, "host_syncs": syncs,
                "host_syncs_per_block": syncs / max(1, blocks), "launches": launches,
                "kv_bytes_per_2048_slot": {
                    "int8": model.kv_bytes_per_slot(),
                    "bfloat16": llama.paged_kv_slot_bytes(model.cfg, model.kv_block_size,
                                                          dtype="bfloat16"),
                },
                "kv_slots_per_card": model.kv_slots_per_chip(),
                "suffix_prefills": len(suffix["host_s"]),
                "suffix_flash_launches": suffix["flash_launches"],
                "suffix_prefill_host_ms": 1e3 * statistics.mean(suffix["host_s"])
                if suffix["host_s"] else None,
                "overlapped": model.overlapped,
                "overlap_breaks": dict(sched.overlap_breaks),
            }
        finally:
            await app.close()
        # the same prompts on a fresh engine with reuse and chunking off:
        # shared-prefix streams equal cold ones, chunked equal monolithic
        cold_spec = _serve_spec(preset, seed, kv_cache_dtype=("int8", "STRING"))
        cold_app, _ = await _boot(cold_spec, device)
        try:
            cold = [_check_replies([await asyncio.to_thread(_post, cold_app.port, body(p, n))],
                                   [p], vocab, n)[0] for p, n in zip(shared + longs, news)]
        finally:
            await cold_app.close()
        rec["shared_equal_to_cold"] = _streams_equal(cold[:len(shared)], outs[:len(shared)])
        rec["chunked_equal_to_monolithic"] = _streams_equal(cold[len(shared):],
                                                            outs[len(shared):])
        rec["ok"] = (rec["prefills_reused"] >= len(shared)
                     and rec["tokens_reused"] >= len(shared) * CACHED_PREFIX
                     and rec["chunks_paced"] >= 1 and blocks > 0 and syncs == blocks
                     and not missing and rec["suffix_flash_launches"] > 0
                     and rec["shared_equal_to_cold"] == len(shared)
                     and rec["chunked_equal_to_monolithic"] == len(longs))
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(
                "serve_cached: reuse, pacing, one host sync per block, a kernel's launch "
                f"(never launched: {missing}), K1 in the suffix prefills, or reused and "
                "chunked streams equal to cold ones is missing")
        return rec

    return asyncio.run(run())


def _divergence(model, prompt, off, on) -> dict:
    """Where greedy stream ``on`` first leaves ``off``, and the logits gap
    there: logit(off's token) - logit(on's token) from one dense prefill of
    ``prompt`` + ``off``'s tokens before that point (the model's dtype)."""
    import torch

    from seldon_core_tpu_torch.models import llama

    i = next((j for j, (a, b) in enumerate(zip(off, on)) if a != b), None)
    if i is None:
        return {"equal_tokens": len(off), "first_divergence": None, "logit_gap": None}
    toks = torch.tensor([list(prompt) + list(off[:i])], dtype=torch.int32, device=model.device)
    logits = llama.forward(model.params, toks, model.cfg)[0, -1].float()
    return {"equal_tokens": i, "first_divergence": i,
            "logit_gap": float(logits[off[i]] - logits[on[i]]),
            "logit_scale": float(logits.abs().max())}


def _verify_rows_vs_steps(model) -> dict:
    """A verify pass (L = 1 + SPEC_DRAFT) against L plain decode steps fed
    the pass's tokens, on copies of one pool, with ``model``'s weights,
    dtype and ``row_split`` (SERVE_SLOTS slots at positions 100-121): for
    each query j whether its logits are the step's at pos + j bit for bit,
    and the pools' bytes after; the same pass with no op split, for
    comparison; and which ops of a layer and the ``lm_head`` keep a row's
    bits at SERVE_SLOTS * L rows against SERVE_SLOTS."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models import llama

    cfg, dev, S, L = model.cfg, model.device, SERVE_SLOTS, 1 + SPEC_DRAFT
    rng = np.random.default_rng(5)
    cache = llama.init_paged_cache(cfg, S, 1 + S * 8, 16, dtype=model.dtype, device=dev)
    for slot in range(S):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 128)).astype(np.int32))
        row = np.zeros(cfg.max_seq // 16, np.int32)
        row[:8] = 1 + 8 * slot + np.arange(8)
        llama.prefill_slot_paged(model.params, toks.to(dev), 100 + 3 * slot, slot, row, cache, cfg)
    qtok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (S, L)).astype(np.int32)).to(dev)
    act = torch.ones(S, dtype=torch.bool, device=dev)
    valid = torch.ones(S, L, dtype=torch.bool, device=dev)

    def verify(row_split):
        pool = {k: v.clone() for k, v in cache.items()}
        out, _ = llama.decode_slots_spec_paged(model.params, qtok, pool, act, valid, cfg,
                                               window=128, row_split=row_split)
        return out, pool

    stepped = {k: v.clone() for k, v in cache.items()}
    steps = []
    for j in range(L):
        out, _ = llama.decode_slots_paged(model.params, qtok[:, j].contiguous(), stepped, act, cfg,
                                          window=128)
        steps.append(out)
    recs = {}
    for name, split in (("row_split", model._row_split), ("unsplit", frozenset())):
        out, pool = verify(split)
        diffs = [float((steps[j].float() - out[:, j].float()).abs().max()) for j in range(L)]
        recs[name] = {
            "ops": sorted(split),
            "rows_bit_equal": [bool(torch.equal(steps[j], out[:, j])) for j in range(L)],
            "max_abs_logit_diff": diffs,
            "argmax_equal": [int((steps[j].argmax(-1) == out[:, j].argmax(-1)).sum())
                             for j in range(L)],
            "pool_bit_equal": all(torch.equal(pool[k][:, 1:], stepped[k][:, 1:])
                                  for k in ("k", "v")),
        }
    variant = llama.row_variant_ops(cfg, S, L, model.dtype, dev)
    return {"dtype": str(model.dtype).replace("torch.", ""), "slots": S, "L": L, **recs,
            "logit_scale": float(steps[0].float().abs().max()),
            "ops_rows_bit_equal": {op: op not in variant for op in llama.ROW_OPS},
            "bit_equal": all(recs["row_split"]["rows_bit_equal"])
            and recs["row_split"]["pool_bit_equal"]}


def phase_serve_spec(serve: dict, device: str = "cuda", preset: str = SERVE_PRESET,
                     seed: int = 0) -> dict:
    """The serve graph with ``spec_draft=3``, once per proposer: the serve
    wave's prompts plus a repetitive one, concurrently.  Returns the
    kernels' launch counts summed over the runs."""
    import numpy as np

    from seldon_core_tpu_torch.ops import _build

    total = {name: 0 for name in KERNELS}
    ledgers: dict = {}  # each method's wave and acceptance ledger, for serve_checkpoint
    for method, extra in SPEC_METHODS.items():
        spec = _serve_spec(preset, seed, spec_draft=(SPEC_DRAFT, "INT"), **extra)

        async def run() -> dict:
            app, boot_s = await _boot(spec, device)
            port = app.port
            try:
                comp = app.service.walker.component
                model, sched = comp.model, comp.scheduler
                vocab = model.cfg.vocab_size
                rng = np.random.default_rng(seed + 100)
                repeat = np.tile(rng.integers(0, vocab, REPEAT_CYCLE),
                                 REPEAT_LEN // REPEAT_CYCLE).tolist()
                prompts = serve["prompts"] + [repeat]
                k1_draft = [0]
                draft_prefill = model.draft_prefill_dispatch

                def counted(*a, **kw):  # K1 launches made by draft-pool prefills
                    before = _build.LAUNCHES["flash_attention"]
                    out = draft_prefill(*a, **kw)
                    k1_draft[0] += _build.LAUNCHES["flash_attention"] - before
                    return out

                model.draft_prefill_dispatch = counted
                _build.reset_launches()  # this method's run starts here
                before = {"blocks": model.decode_blocks, "syncs": model.host_syncs,
                          "block_s": model.block_seconds,
                          "emitted": model.spec_emitted_tokens,
                          "passes": model.spec_verify_passes, "ttft": len(sched.ttft),
                          "draft_prefills": model.draft_prefills}
                loop = asyncio.get_running_loop()
                t1 = time.perf_counter()
                with concurrent.futures.ThreadPoolExecutor(len(prompts)) as clients:
                    replies = await asyncio.gather(*(
                        loop.run_in_executor(clients, _post, port, {"strData": json.dumps(
                            {"tokens": p, "max_new_tokens": MAX_NEW})})
                        for p in prompts))
                wave_s = time.perf_counter() - t1
                launches = dict(_build.LAUNCHES)
                by_l = {str(n): c for n, c in sorted(_build.PAGED_LAUNCHES_BY_L.items())}
                outs = _check_replies(replies, prompts, vocab)
                blocks = model.decode_blocks - before["blocks"]
                syncs = model.host_syncs - before["syncs"]
                passes = model.spec_verify_passes - before["passes"]
                emitted = model.spec_emitted_tokens - before["emitted"]
                steps = _fetched_steps(model, before["blocks"])
                ttft = sorted(t for _, t in list(sched.ttft)[before["ttft"]:])
                agree = [_divergence(model, p, off, on)
                         for p, off, on in zip(serve["prompts"], serve["outs"], outs)]
                rows = _verify_rows_vs_steps(model) if method == "ngram" else None
                rec = {
                    "phase": "serve_spec", "method": method, "preset": preset,
                    "dtype": "bfloat16", "spec_draft": SPEC_DRAFT,
                    "spec": model.spec_snapshot(), "n_slots": SERVE_SLOTS,
                    "decode_block": SERVE_BLOCK, "max_new_tokens": MAX_NEW,
                    "prompt_lens": [len(p) for p in prompts], "boot_and_warmup_s": boot_s,
                    "wave_s": wave_s, "wave_tokens_per_s": len(prompts) * MAX_NEW / wave_s,
                    "ttft_s_p50": statistics.median(ttft), "ttft_s_max": ttft[-1],
                    "verify_passes": passes, "emitted_tokens": emitted,
                    "accepted_tokens_per_pass": emitted / max(1, passes),
                    "ms_per_verify_pass": 1e3 * (model.block_seconds - before["block_s"])
                    / max(1, steps),
                    "decode_blocks": blocks, "host_syncs": syncs,
                    "host_syncs_per_block": syncs / max(1, blocks),
                    "launches": launches, "paged_launches_by_L": by_l,
                    "draft_prefills": model.draft_prefills - before["draft_prefills"],
                    "flash_launches_draft_pool": k1_draft[0],
                    "repeat_prompt_tokens": outs[-1][:16],
                    # gated: greedy speculation on equals off, bit for bit,
                    # in bf16 at full depth too (the verify pass runs the
                    # ops in spec.row_split once per query position)
                    "agreement_with_serve": agree,
                    "streams_equal_to_serve": sum(a["first_divergence"] is None for a in agree),
                    "verify_rows_vs_steps": rows,
                }
                rec["ok"] = (blocks > 0 and syncs == blocks and passes > 0
                             and by_l.get(str(1 + SPEC_DRAFT), 0) > 0
                             and (not method.startswith("draft")
                                  or (k1_draft[0] > 0 and by_l.get("1", 0) > 0))
                             and (method != "draft_self" or emitted > passes)
                             and rec["streams_equal_to_serve"] == len(agree)
                             and (rows is None or rows["bit_equal"]))
                emit(rec)
                ledgers[method] = {"prompts": prompts, "emitted": emitted, "passes": passes,
                                   "boot_s": boot_s}
                if not rec["ok"]:
                    raise AssertionError(
                        f"serve_spec {method}: one host sync per block, verify passes at "
                        f"L={1 + SPEC_DRAFT}, the draft pool's kernels, the self-draft's "
                        "acceptance, the streams of spec off or the verify rows' bits are "
                        "missing")
                return launches
            finally:
                await app.close()

        launches = asyncio.run(run())
        for name in total:
            total[name] += launches[name]
    total["ledgers"] = ledgers
    return total


DISAGG_KV_BLOCKS = 1 + SERVE_SLOTS * 64  # each engine's pool: 8 slots of up to 1024 rows
# the least pool a 2048-token request fits in (128 blocks + the sink): the
# 1500-token prompt's 96 blocks do not fit beside the warmed 33-block chain
DRAM_POOL_BLOCKS = 129
DRAM_GB = 1.0


def _gen(port: int, prompt, headers=None) -> tuple[int, dict]:
    code, body = _call(port, "/disagg/generate", {"tokens": prompt, "max_new_tokens": MAX_NEW},
                       headers)
    return code, json.loads(body)


async def _wave(port: int, prompts, path: str = "/disagg/generate") -> tuple[list, float, list]:
    """``prompts`` concurrently -> (replies, wave seconds, client send times)."""
    loop = asyncio.get_running_loop()
    sent = [0.0] * len(prompts)

    def one(i):
        sent[i] = time.perf_counter()
        if path == "/disagg/generate":
            return _gen(port, prompts[i])
        return _post(port, {"strData": json.dumps({"tokens": prompts[i],
                                                   "max_new_tokens": MAX_NEW})})

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as clients:
        replies = await asyncio.gather(*(loop.run_in_executor(clients, one, i)
                                         for i in range(len(prompts))))
    return replies, time.perf_counter() - t0, sent


def _timed(obj, name: str, log: list) -> None:
    """Wrap ``obj.name`` on the instance to log its host seconds."""
    fn = getattr(obj, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            log.append(time.perf_counter() - t0)

    setattr(obj, name, timed)


def _first_token_times(sched) -> dict:
    """Log, on ``sched``'s instance, when each request's first token lands
    (the decode engine admits an import): prompt tuple -> times."""
    seen: dict = {}
    start = sched._start

    def logged(req, *a, **kw):
        seen.setdefault(tuple(req.prompt.tolist()), []).append(time.perf_counter())
        return start(req, *a, **kw)

    sched._start = logged
    return seen


async def _disagg_wave(a, b, prompts) -> dict:
    """The wave through prefill engine ``a`` (handing off to ``b``): the
    streams, modes, launches by engine, TTFT (client send to the decode
    engine's first token), export and import costs, handoff bytes."""
    from seldon_core_tpu_torch.ops import _build

    ma, mb = (x.service.walker.component.model for x in (a, b))
    sb = b.service.walker.component.scheduler
    firsts = _first_token_times(sb)
    attach: list = []
    _timed(mb, "attach_imported", attach)
    before = {"a": dict(a.disagg_stats), "b": dict(b.disagg_stats), "a_blocks": ma.decode_blocks,
              "b_prefills": mb.prefills, "b_blocks": mb.decode_blocks, "b_syncs": mb.host_syncs,
              "b_block_s": mb.block_seconds}
    _build.reset_launches()  # this wave's run starts here
    replies, wave_s, sent = await _wave(a.port, prompts)
    launches = dict(_build.LAUNCHES)
    del sb._start, mb.attach_imported  # the instance wrappers
    ttft = []
    for i, p in enumerate(prompts):
        times = firsts.get(tuple(p), [])
        if times:
            ttft.append(times.pop(0) - sent[i])
    da = {k: a.disagg_stats[k] - before["a"][k] for k in ("handoffs_ok", "handoff_bytes",
                                                          "export_s", "local_fallbacks")}
    db = {k: b.disagg_stats[k] - before["b"][k] for k in ("imports_ok", "import_decode_s")}
    n = max(1, da["handoffs_ok"])
    rows = sum(-(-len(p) // 16) * 16 for p in prompts)  # the prompt blocks' rows shipped
    blocks = mb.decode_blocks - before["b_blocks"]
    syncs = mb.host_syncs - before["b_syncs"]
    return {
        "replies": replies, "modes": [body.get("mode") for _, body in replies],
        "outs": [body.get("tokens") for _, body in replies],
        "wave_s": wave_s, "wave_tokens_per_s": len(prompts) * MAX_NEW / wave_s,
        "ttft_s_p50": statistics.median(ttft) if ttft else None,
        "ttft_s_max": max(ttft) if ttft else None,
        "ttft_prefill_engine_s_p50": statistics.median(
            t for _, t in list(a.service.walker.component.scheduler.ttft)[-len(prompts):]),
        "handoffs": da["handoffs_ok"], "imports": db["imports_ok"],
        "local_fallbacks": da["local_fallbacks"],
        "handoff_bytes_per_request": da["handoff_bytes"] / n,
        "handoff_bytes_per_prompt_row": da["handoff_bytes"] / max(1, rows),
        "export_ms": 1e3 * da["export_s"] / n,
        "import_ms": 1e3 * (db["import_decode_s"] + sum(attach)) / max(1, db["imports_ok"]),
        "import_frame_decode_ms": 1e3 * db["import_decode_s"] / max(1, db["imports_ok"]),
        "import_attach_host_ms": 1e3 * sum(attach) / max(1, len(attach)),
        "launches_prefill_engine": {"flash_attention": launches["flash_attention"]},
        "launches_decode_engine": {"paged_decode_attention": launches["paged_decode_attention"]},
        "launches": launches,
        # the attribution holds: the prefill engine decoded nothing, the
        # decode engine prefilled nothing
        "prefill_engine_decode_blocks": ma.decode_blocks - before["a_blocks"],
        "decode_engine_prefills": mb.prefills - before["b_prefills"],
        "decode_blocks": blocks, "host_syncs": syncs,
        "decode_step_ms": 1e3 * (mb.block_seconds - before["b_block_s"])
        / max(1, _fetched_steps(mb, before["b_blocks"])),
    }


def _streams_equal(want, got) -> int:
    return sum(a == b for a, b in zip(want, got))


def phase_serve_disagg(serve: dict, device: str = "cuda", preset: str = SERVE_PRESET,
                       seed: int = 0) -> dict:
    """Two engines in one process over loopback HTTP, prefill role (A) and
    decode role (B), answer the serve wave's distinct prompts through
    ``/disagg/generate``: the streams must equal ``serve``'s bit for bit,
    bf16 pools and again int8 pools (against a unified int8 wave); A
    answers ``unified-fallback`` with B stopped and leaks no block; B
    refuses a frame of another block size (409).  A third engine (C)
    pulls a shared prefix's chain from A and serves it from the peer tier
    with A's tokens.  Then the DRAM tier: a pool small enough that a long
    prompt evicts a warmed 512-token prefix, with ``prefix_dram_gb`` set,
    must give the pressure-free run's streams.  Returns the kernels'
    launch counts summed over the runs."""
    import numpy as np

    from seldon_core_tpu_torch.disagg import handoff
    from seldon_core_tpu_torch.ops import _build

    blocks = {"kv_blocks": (DISAGG_KV_BLOCKS, "INT")}
    reuse = {"kv_prefix_reuse": ("true", "BOOL")}
    int8 = {"kv_cache_dtype": ("int8", "STRING")}
    prompts = serve["prompts"]  # the serve wave's distinct prompts
    total = {name: 0 for name in KERNELS}

    def add(launches):
        for name in total:
            total[name] += launches[name]

    async def pair(extra: dict, **a_extra):
        b, b_s = await _boot(_serve_spec(preset, seed, **blocks, **extra), device, role="decode")
        os.environ["SCT_DISAGG_DECODE"] = f"127.0.0.1:{b.port}"
        try:
            a, a_s = await _boot(_serve_spec(preset, seed, **blocks, **extra, **a_extra), device,
                                 role="prefill")
        finally:
            del os.environ["SCT_DISAGG_DECODE"]
        return a, b, a_s + b_s

    async def run() -> dict:
        rec = {"phase": "serve_disagg", "preset": preset, "dtype": "bfloat16",
               "n_slots": SERVE_SLOTS, "kv_block_size": 16, "kv_blocks": DISAGG_KV_BLOCKS,
               "max_new_tokens": MAX_NEW, "prompt_lens": [len(p) for p in prompts],
               "kv_bytes_per_row_computed": 2 * 16 * 8 * 64 * 2}
        # ---- bf16 pools: A (prefill role, with prefix reuse for the peer
        # tier) hands off to B (decode role)
        a, b, boot_s = await pair({}, **reuse)
        c = None
        try:
            ma = a.service.walker.component.model
            free0 = ma.free_block_count
            wave = await _disagg_wave(a, b, prompts)
            add(wave["launches"])
            outs = wave.pop("outs")
            wave.pop("replies")
            rec["bf16"] = {**wave, "boot_s": boot_s,
                           "streams_equal_to_serve": _streams_equal(serve["outs"], outs),
                           "serve_wave_tokens_per_s": serve["wave_tokens_per_s"],
                           "serve_ttft_s_p50": serve["ttft_s_p50"]}
            # a frame of another block size: B refuses it (409)
            sched_a = a.service.walker.component.scheduler
            await _pins_back(sched_a)  # the wave's pinned slots
            args, kw = _pinned_handoff(ma, prompts[0])
            frame = handoff.decode_handoff(await asyncio.to_thread(
                handoff.build_handoff_frame, *args, **kw))
            ma.release_slot(0)
            k, v = (t.reshape(t.shape[0], -1, 8, *t.shape[3:]) for t in (frame["k"], frame["v"]))
            skew = handoff.encode_handoff(frame["prompt"], frame["first_token"], k, v,
                                          block_size=8, max_new_tokens=MAX_NEW)
            code, body = await asyncio.to_thread(_call, b.port, "/disagg/import", skew)
            rec["block_size_skew"] = {"status": code, "body": body[:160].decode(errors="replace")}
            # the peer tier: C pulls A's chain for a prompt sharing the
            # 600-token prompt's first 512 tokens (32 blocks), then A serves
            # the same prompt from its own index: both prefill the same
            # 40-token suffix over the same bytes
            os.environ["SCT_PREFIX_PEER_PULL"] = "1"
            c, _ = await _boot(_serve_spec(preset, seed, **blocks, **reuse), device)
            shared = prompts[-1][:CACHED_PREFIX] + np.random.default_rng(seed + 7).integers(
                0, ma.cfg.vocab_size, 40).tolist()
            _build.reset_launches()
            code_c, at_c = await asyncio.to_thread(
                _gen, c.port, shared, {"x-sct-prefix-peer": f"127.0.0.1:{a.port}"})
            code_a, at_a = await asyncio.to_thread(_gen, a.port, shared)
            add(_build.LAUNCHES)
            snap = c.service.walker.component.model.prefix_snapshot()
            rec["peer"] = {"prompt_len": len(shared), "status": [code_a, code_c],
                           "modes": [at_a.get("mode"), at_c.get("mode")],
                           "tokens_equal_to_a": at_a.get("tokens") == at_c.get("tokens"),
                           "tier_peer_hits": snap["tiers"]["peer"]["hits"],
                           "tier_peer_promotions": snap["tiers"]["peer"]["promotions"],
                           "pull": dict(c.prefix_pull_stats),
                           "a_serves": a.prefix_pull_stats["serves_ok"]}
            rec["peer"]["tier"] = "peer" if rec["peer"]["tier_peer_hits"] == 1 else None
            # B stopped: A decodes locally, the same tokens, no block leaked.
            # The 5-token prompt has no full block, so its streams are the
            # cold prefill's; the longest prompt's pinned slot matches and
            # then hands A's index its full blocks, so the account counts
            # blocks held by the index alone as well as free ones, and its
            # reused prefix + suffix prefill must give serve's cold stream
            await b.close()
            before = await _block_account(ma, sched_a)
            _build.reset_launches()
            long_p = max(prompts, key=len)
            fb = [await asyncio.to_thread(_gen, a.port, p) for p in (prompts[0], prompts[0], long_p)]
            add(_build.LAUNCHES)
            after = await _block_account(ma, sched_a)
            # the same prompt as a unified request on A: the same reused
            # blocks and suffix prefill as the fallback's
            code_u, unified = await asyncio.to_thread(_post, a.port, {"strData": json.dumps(
                {"tokens": long_p, "max_new_tokens": MAX_NEW})})
            rec["fallback"] = {
                "prompt_lens": [len(prompts[0])] * 2 + [len(long_p)],
                "modes": [body.get("mode") for _, body in fb],
                "streams_equal_to_serve": _streams_equal(serve["outs"][:1] * 2,
                                                         [body.get("tokens") for _, body in fb]),
                "long_equal_to_unified": code_u == 200 and fb[2][1].get("tokens") == json.loads(
                    unified["strData"])["tokens"],
                "long_equal_to_serve": fb[2][1].get("tokens")
                == serve["outs"][prompts.index(long_p)],
                "blocks_before": before, "blocks_after": after,
                "free_blocks_at_boot": free0, "stats": dict(a.disagg_stats)}
        finally:
            os.environ.pop("SCT_PREFIX_PEER_PULL", None)
            for app in (a, b, c):
                if app is not None:
                    await app.close()
        # ---- int8 pools: a unified int8 wave on B, then the handoff
        a, b, _ = await pair(int8)
        try:
            _build.reset_launches()
            unified, _, _ = await _wave(b.port, prompts)
            add(_build.LAUNCHES)
            wave = await _disagg_wave(a, b, prompts)
            add(wave["launches"])
            outs = wave.pop("outs")
            wave.pop("replies")
            rec["int8"] = {**wave, "unified_modes": sorted({body["mode"] for _, body in unified}),
                           "streams_equal_to_unified_int8": _streams_equal(
                               [body["tokens"] for _, body in unified], outs)}
        finally:
            await a.close()
            await b.close()
        try:
            rec["dram"] = await _dram_tier(preset, seed, device, add)
        except Exception as e:  # noqa: BLE001 - the record is printed, then the phase fails
            rec["dram"] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        return rec

    rec = asyncio.run(run())
    bf, q, peer, fb, dram = rec["bf16"], rec["int8"], rec["peer"], rec["fallback"], rec["dram"]
    rec["ok"] = (
        bf["modes"] == ["disagg"] * len(prompts) and bf["streams_equal_to_serve"] == len(prompts)
        and bf["launches_prefill_engine"]["flash_attention"] > 0
        and bf["launches_decode_engine"]["paged_decode_attention"] > 0
        and bf["prefill_engine_decode_blocks"] == 0 and bf["decode_engine_prefills"] == 0
        and bf["host_syncs"] == bf["decode_blocks"] > 0
        and q["modes"] == ["disagg"] * len(prompts) and q["unified_modes"] == ["unified"]
        and q["streams_equal_to_unified_int8"] == len(prompts)
        and rec["block_size_skew"]["status"] == 409
        and peer["status"] == [200, 200] and peer["tokens_equal_to_a"] and peer["tier"] == "peer"
        and fb["modes"] == ["unified-fallback"] * 3 and fb["streams_equal_to_serve"] == 2
        and fb["long_equal_to_unified"] and fb["long_equal_to_serve"]
        and fb["blocks_after"]["reclaimable"] == fb["blocks_before"]["reclaimable"]
        == fb["blocks_after"]["pool"] and fb["blocks_after"]["referenced"] == 0
        and dram["ok"])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("serve_disagg: a handoff, fallback, refusal, tier or stream check "
                             "failed (see the record above)")
    return total


async def _pins_back(sched, timeout_s: float = 10.0) -> None:
    """Wait, ``timeout_s`` at most, until ``sched`` has released every slot
    a handoff pinned."""
    deadline = time.perf_counter() + timeout_s
    while (sched._external or sched._external_release) and time.perf_counter() < deadline:
        await asyncio.sleep(0.01)


async def _block_account(model, sched) -> dict:
    """Where an idle reuse-on pool's blocks are, once ``sched``'s pinned
    slots have gone back: free, held by the prefix index alone (the two are
    ``reclaimable``), or referenced by an entry still in use.  A block
    neither free nor in the index has leaked; so has a slot still pinned
    after 10 s."""
    await _pins_back(sched)
    snap = model.prefix_snapshot()
    held = snap["entries"] - snap["referenced"]
    return {"free": snap["free_blocks"], "index_only": held, "referenced": snap["referenced"],
            "reclaimable": snap["free_blocks"] + held, "pool": snap["pool_blocks"]}


def _pinned_handoff(model, prompt):
    """Prefill ``prompt`` into slot 0 of ``model`` (an engine's model, idle)
    -> the arguments of ``build_handoff_frame``."""
    import numpy as np

    p = np.asarray(prompt, np.int32)
    tok = model.admit(0, p, 0.0, 0, reserve_tokens=MAX_NEW)
    return (model, 0, p, tok), {"max_new_tokens": MAX_NEW}


async def _dram_tier(preset: str, seed: int, device: str, add) -> dict:
    """A warmed 512-token prefix, a 1500-token prompt that evicts it from a
    128-block pool into the DRAM tier, then a prompt sharing the prefix
    (promoted back): the streams against the same requests on a pool with
    room for all of it."""
    import numpy as np

    from seldon_core_tpu_torch.models.registry import resolve_config
    from seldon_core_tpu_torch.ops import _build

    rng = np.random.default_rng(seed + 3)
    vocab = resolve_config(preset).vocab_size
    prefix = rng.integers(0, vocab, CACHED_PREFIX).tolist()
    prompts = [prefix + rng.integers(0, vocab, 24).tolist(),
               rng.integers(0, vocab, LONG_LENGTHS[0]).tolist(),
               prefix + rng.integers(0, vocab, 40).tolist()]
    reuse = {"kv_prefix_reuse": ("true", "BOOL"), "prefix_dram_gb": (DRAM_GB, "FLOAT")}
    runs = {}
    for name, extra in (("pressure", {"kv_blocks": (DRAM_POOL_BLOCKS, "INT")}), ("room", {})):
        app, _ = await _boot(_serve_spec(preset, seed, **reuse, **extra), device)
        try:
            comp = app.service.walker.component
            promote: list = []
            _timed(comp.model, "_promote", promote)
            _build.reset_launches()
            outs = []
            for p in prompts:
                code, body = await asyncio.to_thread(_post, app.port, {"strData": json.dumps(
                    {"tokens": p, "max_new_tokens": MAX_NEW})})
                outs.append(json.loads(body["strData"])["tokens"] if code == 200 else None)
            add(_build.LAUNCHES)
            snap = comp.model.prefix_snapshot()
            dram = snap["tiers"]["dram"]
            runs[name] = {"outs": outs, "ttft_s": [t for _, t in comp.scheduler.ttft][-3:],
                          "demotions": dram["demotions"], "promotions": dram["promotions"],
                          "dram_hits": dram["dram_hits"], "dram_bytes": dram["bytes"],
                          "promote_host_ms": [1e3 * t for t in promote],
                          "free_blocks": snap["free_blocks"], "pool_blocks": snap["pool_blocks"]}
        finally:
            await app.close()
    p, r = runs["pressure"], runs["room"]
    rec = {"prompt_lens": [len(x) for x in prompts], "pool_blocks": DRAM_POOL_BLOCKS - 1,
           "prefix_dram_gb": DRAM_GB,
           "streams_equal_to_no_pressure": _streams_equal(r["outs"], p["outs"]),
           **{k: p[k] for k in ("demotions", "promotions", "dram_hits", "dram_bytes",
                                "promote_host_ms")},
           "ttft_s_pressure": p["ttft_s"], "ttft_s_room": r["ttft_s"],
           "room_demotions": r["demotions"]}
    rec["ok"] = (rec["streams_equal_to_no_pressure"] == len(prompts) and p["demotions"] >= 1
                 and p["promotions"] >= 1 and p["dram_hits"] >= 1 and r["demotions"] == 0)
    return rec


def _sse(port: int, body: dict, read_events: int | None = None, headers: str = "",
         on_first=None) -> dict:
    """POST ``body`` to the stream route over a raw socket: the status, the
    content type, the events, and for each event the time its bytes came
    (the socket closes after ``read_events`` events when given).
    ``headers`` (``"name: value\\r\\n"`` lines) join the request head;
    ``on_first()`` runs when the first event's bytes come, and its result
    is returned as ``first``."""
    import socket

    sock = socket.create_connection(("127.0.0.1", port), timeout=600)
    data, times, first = b"", [], None
    try:
        payload = json.dumps(body).encode()
        sock.sendall((f"POST /api/v0.1/predictions/stream HTTP/1.1\r\nHost: smoke\r\n{headers}"
                      f"Content-Length: {len(payload)}\r\nConnection: close\r\n\r\n").encode()
                     + payload)
        while True:
            chunk = sock.recv(1 << 16)
            if not chunk:
                break
            data += chunk
            times += [time.perf_counter()] * chunk.count(b"\n\n")
            if on_first is not None and first is None and b"data: " in data:
                first = on_first()
            if read_events is not None and data.count(b"\n\ndata: ") >= read_events:
                break
    finally:
        sock.close()
    head, _, rest = data.partition(b"\r\n\r\n")
    events = [json.loads(e[len(b"data: "):]) for e in rest.split(b"\n\n")
              if e.startswith(b"data: ")]
    lines = head.decode("latin-1").split("\r\n")
    ctype = next((ln.split(": ", 1)[1] for ln in lines if ln.lower().startswith("content-type")),
                 None)
    return {"status": int(lines[0].split(" ")[1]), "content_type": ctype, "events": events,
            "times": times[-len(events):] if events else [], "first": first}


def phase_serve_stream(device: str = "cuda", preset: str = SERVE_PRESET, seed: int = 0) -> dict:
    """SSE token streaming on the serve graph: a streamed reply equals the
    unstreamed one, written one decode block at a time (the first token
    from the prefill, then 16 a write); a client that leaves mid-stream
    frees its slot once (the free block count comes back); ``/pause`` turns
    ``/ready`` false and ``/unpause`` back.  Returns the launch counts."""
    from seldon_core_tpu_torch.ops import _build

    spec = _serve_spec(preset, seed)

    async def run() -> dict:
        app, _ = await _boot(spec, device)
        port = app.port
        try:
            model = app.service.walker.component.model
            body = {"tokens": VERIFY_PROMPT, "max_new_tokens": MAX_NEW}
            _build.reset_launches()
            sse = await asyncio.to_thread(_sse, port, body)
            launches = dict(_build.LAUNCHES)
            stats = dict(app.stream_stats)
            code, plain = await asyncio.to_thread(_post, port, {"strData": json.dumps(body)})
            tokens = [e["token"] for e in sse["events"] if "token" in e]
            # events that came in one read of the socket: a decode block's
            gaps = [b - a for a, b in zip(sse["times"], sse["times"][1:])]
            free0 = model.free_block_count
            emitted0 = model.tokens_emitted
            long_new = 512
            await asyncio.to_thread(_sse, port, {"tokens": VERIFY_PROMPT,
                                                 "max_new_tokens": long_new}, 2)
            deadline = time.perf_counter() + 60
            while (app.stream_stats["disconnects"] < 1 or model.free_block_count != free0) \
                    and time.perf_counter() < deadline:
                await asyncio.sleep(0.01)
            left = {"disconnects": app.stream_stats["disconnects"],
                    "free_blocks_before": free0, "free_blocks_after": model.free_block_count,
                    "free_blocks_unique": len(set(model._free_blocks)) == model.free_block_count,
                    "tokens_emitted": model.tokens_emitted - emitted0, "max_new_tokens": long_new}
            pause = [await asyncio.to_thread(_get, port, "/ready")]
            for path in ("/pause", "/ready", "/unpause", "/ready"):
                pause.append(await asyncio.to_thread(_get, port, path))
            want = json.loads(plain["strData"])["tokens"]
            rec = {"phase": "serve_stream", "preset": preset, "dtype": "bfloat16",
                   "decode_block": SERVE_BLOCK, "max_new_tokens": MAX_NEW,
                   "status": sse["status"], "content_type": sse["content_type"],
                   "events": len(sse["events"]), "equal_to_unstreamed": tokens == want,
                   "done_event": sse["events"][-1] == {"done": True, "tokens": tokens},
                   "writes": stats["writes"],
                   "writes_want": 1 + -(-(MAX_NEW - 1) // SERVE_BLOCK),
                   "event_gaps_ms": [
                       1e3 * g for g in gaps if g > 0],
                   "disconnect": left, "ready_pause_ready_unpause_ready": pause,
                   "launches": launches}
            rec["ok"] = (code == 200 and rec["status"] == 200
                         and rec["content_type"] == "text/event-stream"
                         and rec["equal_to_unstreamed"] and rec["done_event"]
                         and stats["events"] == MAX_NEW and rec["writes"] == rec["writes_want"]
                         and left["disconnects"] == 1 and left["free_blocks_unique"]
                         and left["free_blocks_after"] == free0
                         and left["tokens_emitted"] < long_new // 2
                         and pause == [200, 200, 503, 200, 200])
            emit(rec)
            if not rec["ok"]:
                raise AssertionError("serve_stream: the streamed reply, its writes per block, "
                                     "the disconnect or the pause toggle failed")
            return launches
        finally:
            await app.close()

    return asyncio.run(run())


def _gen_node(name: str, preset: str, seed: int, **extra) -> dict:
    """A ``JAX_GENERATIVE`` graph node as ``_serve_spec`` builds one (bf16,
    seeded weights, 8 slots, 16-step blocks, 32 new tokens); ``extra``
    adds graph parameters (name -> (value, type))."""
    params = {"family": ("llama", "STRING"), "preset": (preset, "STRING"),
              "dtype": ("bfloat16", "STRING"), "n_slots": (SERVE_SLOTS, "INT"),
              "decode_block": (SERVE_BLOCK, "INT"), "max_new_tokens": (MAX_NEW, "INT"),
              "rng": (seed, "INT"), **extra}
    return {"name": name, "type": "MODEL", "implementation": "JAX_GENERATIVE",
            "parameters": [{"name": k, "value": str(v), "type": t}
                           for k, (v, t) in params.items()]}


def _graph_spec(graph: dict):
    from seldon_core_tpu_torch.graph.spec import PredictorSpec

    return PredictorSpec.from_dict({"name": "smoke-graph", "graph": graph})


def _body(prompt, **extra) -> dict:
    return {"strData": json.dumps({"tokens": prompt, "max_new_tokens": MAX_NEW, **extra})}


async def _direct(comp, bodies) -> list[str]:
    """Each body through ``comp.predict_raw`` directly, concurrently: the
    strData a tier answers when called alone."""
    from seldon_core_tpu_torch.contract.payload import DataKind, Payload

    outs = await asyncio.gather(*(comp.predict_raw(Payload(b["strData"], [], DataKind.STRING))
                                  for b in bodies))
    return [o.data for o in outs]


async def _graph_wave(port: int, bodies, headers=None) -> tuple[list, list, list]:
    """``bodies`` posted concurrently, each with ``headers`` -> ((status,
    reply) pairs, client send times, walls)."""
    replies = await _requests(port, bodies, [headers] * len(bodies))
    return ([(r["status"], json.loads(r["raw"])) for r in replies],
            [r["sent"] for r in replies], [r["s"] for r in replies])


def _ttfts(firsts: dict, prompts, sent) -> list[float]:
    """Client send to the first token of each prompt logged in ``firsts``."""
    out = []
    for p, t0 in zip(prompts, sent):
        times = firsts.get(tuple(p), [])
        if times:
            out.append(times.pop(0) - t0)
    return out


def _conf_overlap_vs_eager(model, prompts) -> dict:
    """Two blocks from the same admitted state, the second continued from
    the first's carry before the first is fetched (the overlap): once on
    the eager loop, once replayed from the captured graphs.  Tokens, masks
    and margins must be bit-equal.  The model is reset after."""
    import numpy as np

    S, k, tps = model.n_slots, model.decode_block, model._tps
    try:
        cur = _admit_all(model, prompts, 2 * k * tps + 1)
        active = np.arange(S) < min(S, len(prompts))
        args = (cur, active, np.zeros(S, np.float32), 1234, np.full(S, -1, np.int32),
                np.full(S, 1000, np.int32), k)
        before = {n: t.clone() for n, t in _device_state(model).items()}
        ceiling = model._pos_ceiling.copy()
        runs = {}
        for name, eager in (("eager", True), ("replay", False)):
            for n, t in _device_state(model).items():
                t.copy_(before[n])
            model._pos_ceiling[:] = ceiling
            model._eager_on_card = eager
            first = model.step_k_dispatch(*args)
            second = model.step_k_continue(active, 4321, k)  # before the first is fetched
            blocks = []
            for h in (first, second):
                toks, mask = model.step_k_fetch(h)
                blocks.append((toks, mask, model.last_conf_seq.copy()))
            runs[name] = blocks
    finally:
        model._eager_on_card = False
        model.reset()
    equal = [bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                  and np.array_equal(a[2].view(np.uint32), b[2].view(np.uint32)))
             for a, b in zip(runs["eager"], runs["replay"])]
    margins = np.concatenate([c[m] for _, m, c in runs["replay"]])
    return {"blocks_bit_equal": equal,
            "tokens_compared": int(sum(m.sum() for _, m, _ in runs["replay"])),
            "margin_mean": float(margins.mean()), "margin_min": float(margins.min()),
            "margin_max": float(margins.max()), "ok": all(equal)}


def _on_off_blocks(model, prompts, switch, *, adapters=None, pairs: int = 5,
                   queued: bool = False, profile_blocks: int = 0) -> tuple[dict, dict, dict]:
    """The same block from one admitted state (``prompts`` in slots 0..,
    through ``adapters`` when given), run with ``switch(True)`` and
    ``switch(False)`` in turn, ``pairs`` pairs after a warm-up pair that is
    not timed; each run restores the state first.  Returns the block ms
    (CUDA events around the replay) and the ``(tokens, mask)`` of each side.
    ``queued`` enqueues a ~10 ms spin kernel before each block, so the block
    is queued whole before its start event fires: its time is then the
    device's alone, not the host's submission of the graph to an idle card.
    ``profile_blocks`` then runs that many more blocks a side, each side
    under a ``torch.profiler`` of its own, returned by side with those
    blocks' ms.  The model is reset after, with ``switch(True)``."""
    import numpy as np
    import torch

    S, k = model.n_slots, model.decode_block
    ms, outs, profiles = {True: [], False: []}, {True: [], False: []}, {}
    try:
        cur = _admit_all(model, prompts, k * model._tps + 1, 0.0, adapters)
        active = np.arange(S) < min(S, len(prompts))
        args = (cur, active, np.zeros(S, np.float32), 1234, np.full(S, -1, np.int32),
                np.full(S, 1000, np.int32), k)
        before = {n: t.clone() for n, t in _device_state(model).items()}
        ceiling = model._pos_ceiling.copy()

        def block(on: bool):
            for n, t in _device_state(model).items():
                t.copy_(before[n])
            model._pos_ceiling[:] = ceiling
            switch(on)
            if queued and model.device.type == "cuda":
                torch.cuda._sleep(20_000_000)
            return model.step_k(*args)

        for i in range(pairs + 1):
            for on in ((False, True) if i % 2 else (True, False)):
                outs[on].append(block(on))
                if i:
                    ms[on].append(1e3 * model.last_block_s)
        for on in ((True, False) if profile_blocks else ()):
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                blocks_ms = []
                for _ in range(profile_blocks):
                    block(on)
                    blocks_ms.append(1e3 * model.last_block_s)
                torch.cuda.synchronize()
            profiles[on] = {"block_ms": blocks_ms, "profile": prof}
    finally:
        switch(True)
        model.reset()
    return ms, outs, profiles


def _on_off_ms(ms: dict, k: int) -> dict:
    on_ms, off_ms = statistics.median(ms[True]), statistics.median(ms[False])
    return {"k": k, "block_ms_on": ms[True], "block_ms_off": ms[False],
            "step_ms_on": on_ms / k, "step_ms_off": off_ms / k,
            "step_ms_added": (on_ms - off_ms) / k, "added_share": on_ms / off_ms - 1.0}


def _conf_cost(model, prompts, pairs: int = 5) -> dict:
    """The margin's cost on a replayed block: the same block from the same
    admitted state, replayed with ``conf_signal`` on and off in turn (off
    captures graphs of its own over output buffers of its own), CUDA events
    around each replay; the first pair is a warm-up.  Tokens and masks must
    be equal.  The model is reset after, with the signal back on."""
    import numpy as np

    bufs = {True: (model._gout, model._hout), False: ({}, {})}
    config = model._program_config[:-1]

    def signal(on: bool) -> None:
        model.conf_signal = on
        model._gout, model._hout = bufs[on]
        model._program_config = config + (on,)

    ms, outs, _ = _on_off_blocks(model, prompts, signal, pairs=pairs)
    equal = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                for a, b in zip(outs[True], outs[False]))
    return {**_on_off_ms(ms, model.decode_block), "tokens_equal": equal}


def _embed_bucket_check(model, prompts) -> dict:
    """One prompt in its bucket and in the next one up, on the card; and
    what the CPU check needs: each prompt's vector on the card and the
    card's bf16 weights as f32 on the CPU."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models import llama

    p = next(p for p in prompts if len(p) == 100)  # bucket 128, and 256
    padded = model._padded(np.asarray(p, np.int32))
    wide = np.zeros((1, 2 * padded.shape[1]), np.int32)
    wide[0, : len(p)] = p
    with torch.no_grad():
        vecs = [llama.embed_pooled(model.params, torch.from_numpy(x).to(model.device), len(p),
                                   model.cfg, op=model._prefill_op).cpu().numpy()
                for x in (padded, wide)]
    rel = float(np.abs(vecs[0] - vecs[1]).max() / max(1e-30, float(np.abs(vecs[0]).max())))
    card = np.stack([model.embed(np.asarray(p, np.int32)) for p in prompts])
    return {"bucket_pair": [padded.shape[1], wide.shape[1]], "bucket_rel_diff": rel,
            "bucket_bits_equal": bool(np.array_equal(vecs[0], vecs[1])),
            "cpu_args": (_f32_on_cpu(model.params), prompts, card)}


def _embed_vs_cpu(cpu, prompts, card) -> dict:
    """Each prompt's card vector against the CPU f32 port at full depth
    (unpadded: the causal rows ignore the padding)."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models import llama

    t0 = time.perf_counter()
    cos, errs = [], []
    with torch.no_grad():
        for p, v in zip(prompts, card):
            r = llama.embed_pooled(cpu, torch.tensor([p], dtype=torch.int32), len(p),
                                   cpu.cfg).numpy()
            cos.append(float(np.dot(r, v) / (np.linalg.norm(r) * np.linalg.norm(v))))
            errs.append(float(np.abs(r - v).max()))
    return {"cosine_min": min(cos), "cosine": cos, "max_abs_err": max(errs),
            "seconds": time.perf_counter() - t0}


def _logged_decide(casc, reasons: list) -> None:
    """Log, on ``casc``'s instance, the reason of each cascade decision."""
    decide = casc.decide

    def logged(*a):
        out = decide(*a)
        reasons.append(out[1])
        return out

    casc.decide = logged


async def _cascade_waves(app, prompts, want, bodies) -> dict:
    """Engine G1's gated waves: threshold 0, +inf, +inf under a deadline
    the next tier's TTFT cannot fit, the guardrail, the embeddings and the margins' replay check;
    launches of the served waves under ``launches``."""
    import numpy as np

    from seldon_core_tpu_torch.contract.payload import DataKind, Payload
    from seldon_core_tpu_torch.ops import _build

    comps = dict(app.service.walker.iter_components())
    guard, casc, small, large = (comps[n] for n in ("guard", "casc", "small", "large"))
    sm, lm = small.model, large.model
    reasons: list = []
    _logged_decide(casc, reasons)
    rec = {"warmup_s": dict(app.service.walker.warmup_seconds),
           "large_model": {"preset": GRAPH_LARGE, "layers": lm.cfg.n_layers,
                           "hidden": lm.cfg.hidden, "head_dim": lm.cfg.head_dim,
                           "max_seq": lm.cfg.max_seq,
                           "capture_s": [g["capture_s"] for g in lm.program_snapshot()["graphs"]],
                           "prefill_split": sorted(lm._prefill_split)}}
    # the engine's first wave, shipped cheap: its TTFT is printed apart (a
    # capture empties the allocator's cache, and the 8b's captures came
    # after the 1b's prefill buckets), and the timed waves come after it
    firsts = {"small": _first_token_times(small.scheduler),
              "large": _first_token_times(large.scheduler)}
    casc.threshold = 0.0
    _, sent, _ = await _graph_wave(app.port, bodies)
    rec["first_wave_ttft_s_p50"] = statistics.median(_ttfts(firsts["small"], prompts, sent)
                                                     or [0.0])
    _build.reset_launches()  # the graph's served run starts here
    casc.threshold = 0.0  # nothing escalates
    s0 = (sm.decode_blocks, sm.host_syncs, sm.block_seconds)
    cheap, sent0, wall0 = await _graph_wave(app.port, bodies)
    s1 = (sm.decode_blocks, sm.host_syncs, sm.block_seconds)
    small_step_ms = 1e3 * (s1[2] - s0[2]) / max(1, _fetched_steps(sm, s0[0]))
    cheap_ttft = _ttfts(firsts["small"], prompts, sent0)
    casc.threshold = float("inf")  # everything escalates
    e0 = (casc.escalations, lm.block_seconds, lm.decode_blocks, lm.host_syncs)
    esc, sent1, wall1 = await _graph_wave(app.port, bodies)
    e1 = (casc.escalations, lm.block_seconds, lm.decode_blocks, lm.host_syncs)
    large_step_ms = 1e3 * (e1[1] - e0[1]) / max(1, _fetched_steps(lm, e0[2]))
    esc_ttft = _ttfts(firsts["large"], prompts, sent1)
    n_before = len(reasons)  # +inf under a budget that cannot fit the 8b's TTFT
    # a deadline tier 0 can meet (the schedulers reap a request whose
    # deadline passes, as the JAX ones do) under a next-tier TTFT above it
    ttft_ms, casc.ttft_ms = casc.ttft_ms, 60000.0
    late, _, _ = await _graph_wave(app.port, bodies[:2], {"x-sct-deadline-ms": "30000"})
    casc.ttft_ms = ttft_ms
    late_reasons = reasons[n_before:]
    casc.threshold = 0.0  # the guardrail's requests ship from tier 0
    scrubs = guard.actions.get("scrub", 0)  # an e-mail address in a string field
    mail = _body(prompts[0], note="write to jane.doe@example.com")
    code_mail, raw_mail = await asyncio.to_thread(_call, app.port, "/api/v0.1/predictions", mail)
    code_block, raw_block = await asyncio.to_thread(
        _call, app.port, "/api/v0.1/predictions", _body(prompts[0], note="a forbidden-topic"))
    e2 = (sm.embeds, sm.embed_fetches, _build.LAUNCHES["flash_attention"], time.perf_counter())
    code_e, raw_e = await asyncio.to_thread(_call, app.port, "/api/v0.1/embeddings",
                                            {"tokens": prompts})
    embed_ms = 1e3 * (time.perf_counter() - e2[3])
    rec["launches"] = dict(_build.LAUNCHES)  # the served run ends here
    # the 8b's launches are those at head dim 128
    rec["launches_by_head_dim"] = dict(sorted(_build.LAUNCHES_BY_D.items()))
    # the tiers called directly, after the launches are read (greedy: the
    # same bodies give the same replies whenever they are asked)
    seen = guard.transform_input_raw(Payload(mail["strData"], [], DataKind.STRING))
    direct = await _direct(small, bodies + [{"strData": seen.data}])
    direct, scrubbed_direct = direct[:-1], direct[-1]
    direct_large = await _direct(large, bodies)
    rec["threshold_0"] = {
        "status": [c for c, _ in cheap],
        "routing": [b.get("meta", {}).get("routing") for _, b in cheap],
        "byte_equal_to_small": sum(b.get("strData") == d for (_, b), d in zip(cheap, direct)),
        "tokens_equal_to_serve": sum(json.loads(b["strData"])["tokens"] == w
                                     for (_, b), w in zip(cheap, want) if "strData" in b),
        "confidence": [json.loads(b["strData"]).get("confidence") for _, b in cheap
                       if "strData" in b],
        "decode_blocks": s1[0] - s0[0], "host_syncs": s1[1] - s0[1],
        "small_decode_step_ms": small_step_ms,
        "ttft_s_p50": statistics.median(cheap_ttft or [0.0]),
        "wall_s_p50": statistics.median(wall0)}
    rec["threshold_inf"] = {
        "status": [c for c, _ in esc],
        "routing": [b.get("meta", {}).get("routing") for _, b in esc],
        "byte_equal_to_large": sum(b.get("strData") == d for (_, b), d in zip(esc, direct_large)),
        "escalations": e1[0] - e0[0],
        "ttft_s_p50": statistics.median(esc_ttft or [0.0]),
        "wall_s_p50": statistics.median(wall1),
        "large_decode_step_ms": large_step_ms,
        "large_decode_blocks": e1[2] - e0[2], "large_host_syncs": e1[3] - e0[3],
        "large_tokens": [json.loads(b["strData"])["tokens"][:8] for _, b in esc[:2]
                         if "strData" in b]}
    rec["deadline_budget"] = {
        "status": [c for c, _ in late], "reasons": late_reasons,
        "routing": [b.get("meta", {}).get("routing") for _, b in late],
        "byte_equal_to_small": sum(b.get("strData") == d for (_, b), d in zip(late, direct))}
    rec["guardrail"] = {
        "status": code_mail, "scrubbed_text": json.loads(seen.data)["note"],
        "scrub_actions": guard.actions.get("scrub", 0) - scrubs,
        "reply_equal_to_small_on_scrubbed": json.loads(raw_mail).get("strData")
        == scrubbed_direct,
        "block_status": code_block,
        "block_reply": json.loads(raw_block).get("status", {}).get("status")}
    emb = json.loads(raw_e).get("rawTensor", {})
    rec["embeddings"] = {
        "wall_ms": embed_ms, "prompt_tokens": sum(map(len, prompts)),
        "status": code_e, "shape": emb.get("shape"), "dtype": emb.get("dtype"),
        "embeds": sm.embeds - e2[0], "fetches": sm.embed_fetches - e2[1],
        "flash_launches": rec["launches"]["flash_attention"] - e2[2]}
    if emb.get("data"):
        import base64

        vecs = np.frombuffer(base64.b64decode(emb["data"]), np.float32).reshape(emb["shape"])
        rec["embeddings"]["wave_equals_single"] = bool(np.array_equal(
            vecs[0], sm.embed(np.asarray(prompts[0], np.int32))))
    rec["embeddings"]["card_vs_cpu"] = await asyncio.to_thread(_embed_bucket_check, sm, prompts)
    # the margins: a replayed block, and one continued from its carry before
    # the first is fetched, against the eager loop
    rec["conf_replay"] = await asyncio.to_thread(_conf_overlap_vs_eager, sm, prompts)
    rec["conf_cost"] = await asyncio.to_thread(_conf_cost, sm, prompts)
    rec["cascade"] = {"escalations": casc.escalations,
                      "served_by_tier": {str(k): v for k, v in casc.served_by_tier.items()}}
    return rec


def _g1_gates(rec: dict, n: int) -> dict:
    t0, ti, late, guard, emb = (rec[k] for k in ("threshold_0", "threshold_inf",
                                                 "deadline_budget", "guardrail", "embeddings"))
    return {
        "threshold_0": (t0["status"] == [200] * n and t0["routing"] == [{"casc": 0}] * n
                        and t0["byte_equal_to_small"] == n and t0["tokens_equal_to_serve"] == n
                        and t0["decode_blocks"] > 0 and t0["host_syncs"] == t0["decode_blocks"]),
        "threshold_inf": (ti["status"] == [200] * n and ti["routing"] == [{"casc": 1}] * n
                          and ti["byte_equal_to_large"] == n and ti["escalations"] == n
                          and ti["large_host_syncs"] == ti["large_decode_blocks"] > 0),
        "deadline": (late["reasons"] == ["deadline-budget"] * 2
                     and late["routing"] == [{"casc": 0}] * 2
                     and late["byte_equal_to_small"] == 2),
        "guardrail": (guard["status"] == 200 and "@" not in guard["scrubbed_text"]
                      and "[REDACTED]" in guard["scrubbed_text"] and guard["scrub_actions"] >= 1
                      and guard["reply_equal_to_small_on_scrubbed"]
                      and guard["block_reply"] == "FAILURE"),
        "embeddings": (emb["status"] == 200 and emb["fetches"] == 1 and emb["embeds"] == n
                       and emb["flash_launches"] > 0 and emb.get("wave_equals_single", False)
                       and emb["card_vs_cpu"]["cosine_min"] >= 0.999
                       and emb["card_vs_cpu"]["bucket_rel_diff"] <= 1e-3),
        "conf_replay": rec["conf_replay"]["ok"],
        "conf_on_off_tokens_equal": rec["conf_cost"]["tokens_equal"],
    }


async def _bandit_feedback(app) -> dict:
    """Engine G2: each request (prompts of 8-47 tokens made from a seed),
    then its feedback (reward 1 on branch 1); a host-only EpsilonGreedy of
    the same seed fed the same rewards."""
    import numpy as np

    from seldon_core_tpu_torch.graph.units import EpsilonGreedy
    from seldon_core_tpu_torch.ops import _build

    comps = dict(app.service.walker.iter_components())
    rng, vocab = np.random.default_rng(7), comps["g0"].model.cfg.vocab_size
    asks = [rng.integers(0, vocab, 8 + (i * 7) % 40).tolist() for i in range(BANDIT_REQUESTS)]
    ref = EpsilonGreedy(n_branches=2, epsilon=0.2, seed=7)
    branches, host, feedback, served = [], [], [], []
    _build.reset_launches()  # the bandit's served run starts here
    for p in asks:
        body = _body(p)
        code, raw = await asyncio.to_thread(_call, app.port, "/api/v0.1/predictions", body)
        reply = json.loads(raw)
        b = reply["meta"]["routing"]["ab"]
        h = ref.route(None, [])
        branches.append(b)
        host.append(h)
        served.append((b, body, code, reply.get("strData")))
        ref.send_feedback(None, [], 1.0 if h == 1 else 0.0, routing=h)
        fb = await asyncio.to_thread(_call, app.port, "/api/v0.1/feedback", {
            "request": body, "response": reply, "reward": 1.0 if b == 1 else 0.0})
        feedback.append(fb[0])
    launches = dict(_build.LAUNCHES)  # the served run ends here
    equal = 0  # each reply against its branch called directly, one at a time as served
    for b, body, code, data in served:
        equal += int(code == 200 and data == (await _direct(comps[f"g{b}"], [body]))[0])
    return {"branches": branches, "host_only_branches": host,
            "replies_equal_to_branch": equal, "feedback_status": sorted(set(feedback)),
            "router_pulls": comps["ab"].pulls.tolist(),
            "router_value": comps["ab"].value.tolist(), "launches": launches}


def phase_serve_graph(serve: dict, device: str = "cuda") -> dict:
    """Inference graphs on the card: engine G1 (guardrail -> cascade over
    llama3-1b and llama3-8b) and, after it is closed, engine G2 (an
    epsilon-greedy bandit over two llama3-1b under ``/feedback``).  Returns
    the launch counts of their served runs."""
    import gc

    import numpy as np
    import torch

    prompts, want = serve["prompts"], serve["outs"]
    g1 = {"name": "guard", "type": "GUARDRAIL", "implementation": "GUARDRAIL",
          "parameters": [{"name": "scrub_pii", "value": "true", "type": "BOOL"},
                         {"name": "block", "value": "forbidden-topic", "type": "STRING"}],
          "children": [{
              "name": "casc", "type": "CASCADE_ROUTER", "implementation": "CASCADE_ROUTER",
              "parameters": [{"name": "ttft_ms", "value": str(GRAPH_TTFT_MS), "type": "FLOAT"}],
              "children": [
                  _gen_node("small", SERVE_PRESET, 0, conf_signal=("true", "BOOL"),
                            embed=("true", "BOOL")),
                  _gen_node("large", GRAPH_LARGE, 0, max_seq=(GRAPH_LARGE_MAX_SEQ, "INT")),
              ]}]}
    g2 = {"name": "ab", "type": "ROUTER", "implementation": "EPSILON_GREEDY",
          "parameters": [{"name": "n_branches", "value": "2", "type": "INT"},
                         {"name": "epsilon", "value": "0.2", "type": "FLOAT"},
                         {"name": "seed", "value": "7", "type": "INT"}],
          "children": [_gen_node(f"g{i}", SERVE_PRESET, i, n_layers=(BANDIT_LAYERS, "INT"))
                       for i in (0, 1)]}

    async def run(graph, drive, *args) -> dict:
        app, boot_s = await _boot(_graph_spec(graph), device)
        try:
            return {"boot_and_warmup_s": boot_s, **await drive(app, *args)}
        finally:
            await app.close()

    g1_rec = asyncio.run(run(g1, _cascade_waves, prompts, want,
                             [_body(p) for p in prompts]))
    gc.collect()
    torch.cuda.empty_cache()  # the 8b's blocks go back before G2's captures
    cpu_args = g1_rec["embeddings"]["card_vs_cpu"].pop("cpu_args")
    # the embeddings' CPU reference runs on the host while G2 serves
    with concurrent.futures.ThreadPoolExecutor(1) as host:
        cpu_check = host.submit(_embed_vs_cpu, *cpu_args)
        del cpu_args
        g2_rec = asyncio.run(run(g2, _bandit_feedback))
        g1_rec["embeddings"]["card_vs_cpu"].update(cpu_check.result())
    gc.collect()
    torch.cuda.empty_cache()
    launches = {name: g1_rec["launches"].get(name, 0) + g2_rec["launches"].get(name, 0)
                for name in KERNELS}
    gates = _g1_gates(g1_rec, len(prompts))
    gates["bandit"] = (g2_rec["branches"] == g2_rec["host_only_branches"]
                       and set(g2_rec["branches"]) == {0, 1}
                       and g2_rec["replies_equal_to_branch"] == BANDIT_REQUESTS
                       and g2_rec["feedback_status"] == [200])
    rec = {"phase": "serve_graph", "dtype": "bfloat16", "small": SERVE_PRESET,
           "large": GRAPH_LARGE, "requests": len(prompts),
           "serve_decode_step_ms": serve.get("decode_step_ms"), **g1_rec, "bandit": g2_rec,
           "launches_total": launches, "gates": gates,
           "ok": all(gates.values()) and all(n > 0 for n in launches.values())}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"serve_graph: gates {gates}, launches {launches}")
    return launches


LORA_RANK = 16
LORA_SLOTS = 8  # pool rows, row 0 the null adapter
LORA_ADAPTERS = ("alpha", "beta", "gamma", "delta")
LORA_MIX = [None, "alpha", "beta", None, "gamma", "delta", "alpha", None]  # serve's 8 prompts
# llama.lora_pool_bytes(llama3-1b, 8 rows, rank 16, qkvo+mlp, bf16)
LORA_POOL_BYTES = 180_355_072
LORA_PREFIX = 512
LORA_SHARED = (("alpha", 24), ("beta", 40), ("alpha", 17))  # (adapter, suffix tokens)


def _lora_extra(**extra) -> dict:
    """The serve graph's LoRA parameters (name -> (value, type))."""
    return {"lora_rank": (LORA_RANK, "INT"), "lora_slots": (LORA_SLOTS, "INT"),
            "lora_targets": ("qkvo+mlp", "STRING"),
            "lora_adapters": (",".join(LORA_ADAPTERS), "STRING"), **extra}


async def _adapter_wave(port: int, prompts, adapters, path: str = "/api/v0.1/predictions"
                        ) -> tuple[list[list[int]], list[dict]]:
    """``prompts`` concurrently, each naming its adapter (None: the base
    model) -> (token lists, reply bodies); every reply must be 200."""
    loop = asyncio.get_running_loop()

    def one(i):
        body = {"tokens": prompts[i], "max_new_tokens": MAX_NEW}
        if adapters[i]:
            body["adapter"] = adapters[i]
        code, raw = _call(port, path, body if path == "/disagg/generate"
                          else {"strData": json.dumps(body)})
        return code, json.loads(raw)

    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as clients:
        replies = await asyncio.gather(*(loop.run_in_executor(clients, one, i)
                                         for i in range(len(prompts))))
    for code, obj in replies:
        if code != 200:
            raise AssertionError(f"serve_lora: a request failed ({code}): {obj}")
    outs = [obj["tokens"] if "tokens" in obj else json.loads(obj["strData"])["tokens"]
            for _, obj in replies]
    return outs, [obj for _, obj in replies]


def _admit_all(model, prompts, reserve: int, temperature: float = 0.0, adapters=None):
    """Admit ``prompts`` into slots 0.. (through ``adapters`` when given);
    the first tokens, ``(n_slots,)`` int32."""
    import numpy as np

    cur = np.zeros(model.n_slots, np.int32)
    for i, p in enumerate(prompts[:model.n_slots]):
        cur[i] = model.admit(i, np.asarray(p, np.int32), temperature, 11 + i,
                             reserve_tokens=reserve, adapter=adapters[i] if adapters else None)
    return cur


def _lora_switch(model):
    """``switch(on)`` for :func:`_on_off_blocks`: the LoRA deltas on, or
    off (the pool unbound).  Off keys the model's graphs with a marker
    added, so it captures and replays a graph of its own."""
    lora, config = model._lora, model._program_config
    off_config = config + ("lora off",)

    def deltas(on: bool) -> None:
        model._lora = lora if on else None
        model._program_config = config if on else off_config

    return deltas


def _lora_cost(model, prompts, adapters, pairs: int = 5) -> dict:
    """The adapters' cost on a replayed block: the same 16-step block from
    one admitted state (``adapters`` bound), with the LoRA deltas on and off
    in turn (off captures a graph of its own, keyed without the LoRA
    geometry).  ``host_paced`` starts each block on an idle card, so its
    time holds the host's submission of the graph (as ``_conf_cost``);
    ``queued`` times the device alone (``_on_off_blocks``)."""
    out = {"adapters": list(adapters)}
    for variant in ("host_paced", "queued"):
        ms, _, _ = _on_off_blocks(model, prompts, _lora_switch(model), adapters=adapters,
                                  pairs=pairs, queued=variant == "queued")
        out[variant] = _on_off_ms(ms, model.decode_block)
    return out


def phase_serve_lora(serve: dict, device: str = "cuda", preset: str = SERVE_PRESET,
                     seed: int = 0) -> dict:
    """Batched multi-LoRA on the serve graph (llama3-1b, bf16, 8 slots,
    16-step blocks) with ``lora_rank=16``, ``lora_slots=8``,
    ``lora_targets=qkvo+mlp`` and four adapters.  Engine B (all features:
    ``kv_prefix_reuse``, ``prefill_chunk=256``, ``spec_draft=3`` ngram) boots
    first; engine A (the LoRA parameters alone, ``prefill`` role with B as
    its decode peer) answers serve's 8 prompts as one mixed-adapter wave
    and one wave per adapter; B answers the mixed wave and a shared
    512-token prefix under alpha, beta, alpha; A hands alpha and the other
    adapters' prompts off to B; then, mid-traffic, A's pool is filled and
    one more adapter evicts the least recently used idle row.  Gates: the
    null rows equal serve's streams, each adapter row its solo wave's and
    differs from the base stream, B's streams equal A's, beta reuses no
    token and the second alpha the prefix, the handoffs equal A's unified
    streams, a frame naming an adapter B lacks is refused by name, one
    sync per block, no graph captured after warmup, a replayed block on the
    rewritten row equals the eager one, the new adapter's wave on A equals
    its wave on B (which registers it into a fresh row) and differs from
    the others', and the ledger's ``adapter_pool`` is ``lora_pool_bytes``.  Returns the launch counts of the served run."""
    import numpy as np

    from seldon_core_tpu_torch.disagg import handoff
    from seldon_core_tpu_torch.models import llama
    from seldon_core_tpu_torch.ops import _build

    prompts, want = serve["prompts"], serve["outs"]
    rng = np.random.default_rng(seed + 8)
    vocab = max(max(p) for p in prompts) + 1  # within the served vocab
    prefix = rng.integers(0, vocab, LORA_PREFIX).tolist()
    shared = [(a, prefix + rng.integers(0, vocab, n).tolist()) for a, n in LORA_SHARED]
    all_on = _lora_extra(kv_prefix_reuse=("true", "BOOL"), prefill_chunk=(CACHED_CHUNK, "INT"),
                         spec_draft=(SPEC_DRAFT, "INT"))

    async def run() -> dict:
        b, b_s = await _boot(_serve_spec(preset, seed, **all_on), device)
        a = None
        try:
            a, a_s = await _boot(_serve_spec(preset, seed, **_lora_extra()), device,
                                 role="prefill", decode_upstreams=[f"127.0.0.1:{b.port}"])
            ma, mb = (x.service.walker.component.model for x in (a, b))
            rec = {"phase": "serve_lora", "preset": preset, "dtype": "bfloat16",
                   "n_slots": SERVE_SLOTS, "decode_block": SERVE_BLOCK, "max_new_tokens": MAX_NEW,
                   "lora_rank": LORA_RANK, "lora_slots": LORA_SLOTS, "lora_targets": "qkvo+mlp",
                   "adapters": list(LORA_ADAPTERS), "mix": LORA_MIX,
                   "boot_and_warmup_s": {"a": a_s, "b": b_s}}
            warm = {"a": ma.program_compiles, "b": mb.program_compiles}
            _build.reset_launches()  # the served run starts here
            c0 = (ma.decode_blocks, ma.host_syncs, ma.block_seconds)
            t0 = time.perf_counter()
            mixed, _ = await _adapter_wave(a.port, prompts, LORA_MIX)
            wave_s = time.perf_counter() - t0
            c1 = (ma.decode_blocks, ma.host_syncs, ma.block_seconds)
            step_ms = 1e3 * (c1[2] - c0[2]) / max(1, _fetched_steps(ma, c0[0]))
            solo = {ad: (await _adapter_wave(a.port, prompts, [ad] * len(prompts)))[0]
                    for ad in LORA_ADAPTERS}
            cold = [(await _adapter_wave(a.port, [p], [ad]))[0][0] for ad, p in shared]
            # B: every feature on, the mixed wave and the shared prefix
            sb0 = (mb.decode_blocks, mb.host_syncs)
            mixed_b, _ = await _adapter_wave(b.port, prompts, LORA_MIX)
            reuse, warm_b = [], []
            for ad, p in shared:
                t_reused = mb.prefix_index.snapshot()["tokens_reused"]
                warm_b.append((await _adapter_wave(b.port, [p], [ad]))[0][0])
                reuse.append(mb.prefix_index.snapshot()["tokens_reused"] - t_reused)
            sb1 = (mb.decode_blocks, mb.host_syncs)
            # handoffs A -> B of every adapter row of the mix
            rows = [i for i, ad in enumerate(LORA_MIX) if ad]
            hand, hand_objs = await _adapter_wave(a.port, [prompts[i] for i in rows],
                                                  [LORA_MIX[i] for i in rows], "/disagg/generate")
            launches = dict(_build.LAUNCHES)  # the served run ends here
            by_d = dict(sorted(_build.LAUNCHES_BY_D.items()))
            # mid-traffic registration: fill A's pool, then, while a wave
            # decodes through alpha, one more adapter evicts the LRU idle row
            for name in ("e1", "e2", "e3"):
                await asyncio.to_thread(ma.register_adapter, name)
            evictions0 = ma.lora_pool.evictions
            blocks0 = ma.decode_blocks
            inflight = asyncio.create_task(_adapter_wave(a.port, prompts, ["alpha"] * len(prompts)))
            deadline = time.perf_counter() + 60
            while ma.decode_blocks == blocks0 and time.perf_counter() < deadline:
                await asyncio.sleep(0.005)
            registered_mid_block = ma.decode_blocks > blocks0 and not inflight.done()
            row = await asyncio.to_thread(ma.register_adapter, "zeta")
            during, _ = await inflight
            snap = ma.adapters_snapshot()
            evicted = sorted(set(LORA_ADAPTERS + ("e1", "e2", "e3")) - set(snap["adapters"]))
            try:
                zeta = await asyncio.to_thread(_replay_vs_eager, ma, prompts, 0.0, ["zeta"] * 8)
            finally:
                ma.reset()
            # a frame naming an adapter B does not hold: refused by name
            p0 = np.asarray(prompts[0], np.int32)
            tok = await asyncio.to_thread(ma.admit, 0, p0, 0.0, 0, MAX_NEW, "zeta")
            frame = await asyncio.to_thread(handoff.build_handoff_frame, ma, 0, p0, tok,
                                            max_new_tokens=MAX_NEW)
            ma.release_slot(0)
            code_refused, body_refused = await asyncio.to_thread(_call, b.port, "/disagg/import",
                                                                 frame)
            code_unknown, _ = await asyncio.to_thread(_call, a.port, "/api/v0.1/predictions", {
                "strData": json.dumps({"tokens": prompts[0], "adapter": evicted[0]
                                       if evicted else "missing"})})
            # the rewritten row's content: A's zeta wave (captured graphs
            # over the row the evicted adapter left) against B's, where
            # zeta takes a row no adapter held (the same crc32 seed)
            await asyncio.to_thread(mb.register_adapter, "zeta")
            zeta_a = (await _adapter_wave(a.port, prompts, ["zeta"] * len(prompts)))[0]
            zeta_b = (await _adapter_wave(b.port, prompts, ["zeta"] * len(prompts)))[0]
            compiles_after = {"a": ma.program_compiles, "b": mb.program_compiles}
            # the deltas' cost from one admitted state, after the capture
            # gate; the evicted adapter's rows go through zeta
            cost = await asyncio.to_thread(_lora_cost, ma, prompts, [
                ad if ad is None or ad in snap["adapters"] else "zeta" for ad in LORA_MIX])
            ledger = ma.memory.snapshot()
            own = ledger["owners"][ma._mem_key]
            base_rows = [i for i, ad in enumerate(LORA_MIX) if not ad]
            gates = {
                "null_rows_equal_serve": all(mixed[i] == want[i] for i in base_rows),
                "mixed_equals_solo": all(mixed[i] == solo[ad][i] for i in rows
                                         for ad in [LORA_MIX[i]]),
                "adapter_rows_differ_from_base": all(mixed[i] != want[i] for i in rows),
                "all_features_equal_plain": mixed_b == mixed and warm_b == cold,
                "prefix_reuse_per_adapter": reuse == [0, 0, LORA_PREFIX],
                "handoff_equals_unified": (hand == [mixed[i] for i in rows]
                                           and all(o["mode"] == "disagg" for o in hand_objs)),
                "handoff_refused_by_name": (code_refused == 409 and b"zeta" in body_refused
                                            and b"not resident" in body_refused),
                "unknown_adapter_400": code_unknown == 400,
                "one_sync_per_block": (c1[1] - c0[1] == c1[0] - c0[0] > 0
                                       and sb1[1] - sb0[1] == sb1[0] - sb0[0] > 0),
                "no_capture_after_warmup": compiles_after == warm,
                "eviction_past_capacity": (ma.lora_pool.evictions == evictions0 + 1
                                           and snap["resident"] == LORA_SLOTS - 1
                                           and len(evicted) == 1 and registered_mid_block),
                "wave_during_registration_unchanged": during == solo["alpha"],
                "replay_equals_eager_on_new_row": zeta["ok"],
                "new_row_written": (zeta_a == zeta_b and zeta_a != want
                                    and all(zeta_a != solo[ad] for ad in LORA_ADAPTERS)),
                "ledger_adapter_pool": own["adapter_pool"] == ma.lora_bytes == LORA_POOL_BYTES,
            }
            rec.update({
                "wave_s": wave_s, "decode_step_ms_mixed_wave": step_ms,
                "decode_blocks": c1[0] - c0[0], "host_syncs": c1[1] - c0[1],
                "prefix_tokens_reused": reuse, "evicted": evicted, "zeta_row": row,
                "registered_mid_block": registered_mid_block, "replay_vs_eager": zeta,
                "step_cost": cost, "refusal": body_refused[:200].decode("utf-8", "replace"),
                "row_split_b": sorted(mb._row_split),
                "prefill_split_a": sorted(ma._prefill_split),
                "delta_ops_split": {
                    "verify_L4": sorted(o for o in mb._row_split if o.endswith(".lora")),
                    "prefill": sorted(o for o in ma._prefill_split if o.endswith(".lora"))},
                "ledger": {"budget_bytes": ledger["budget_bytes"],
                           "reserved_bytes": ledger["reserved_bytes"],
                           "owners": len(ledger["owners"]), "a": own,
                           "lora_pool_bytes": llama.lora_pool_bytes(
                               ma.cfg, LORA_SLOTS, LORA_RANK, ma.lora_targets, ma.dtype)},
                "adapters_a": snap, "launches": launches, "launches_by_head_dim": by_d,
                "gates": gates,
            })
            rec["ok"] = all(gates.values()) and all(n > 0 for n in launches.values())
            emit(rec)
            if not rec["ok"]:
                raise AssertionError(f"serve_lora: gates {gates}, launches {launches}")
            return launches
        finally:
            if a is not None:
                await a.close()
            await b.close()

    return asyncio.run(run())


# serve_zoo: the predict path (JAX_MODEL units) at full width, bf16 served
ZOO_PRESETS = {"resnet": "resnet50", "bert": "base", "cnn": "default", "mlp": "default"}
ZOO_BUCKETS = {"resnet": (16, 32), "bert": (64, 256), "cnn": (64, 256), "mlp": (64, 256)}
ZOO_REF_ROWS = 4
BERT_TOKENS = 128
# float32 on the card (TF32 off) against float32 on the CPU, same weights:
# log-probabilities within this share of max(1, the largest |log p|), over
# the classes whose CPU probability exceeds ZOO_TINY_P (smaller ones are
# rounded to 0 on either side).  The card's cuDNN and cuBLAS sum in other
# orders (cuDNN may pick Winograd for a 3x3), ~1e-6 a layer; a wrong pad,
# layout or statistic moves the logits by O(1).
ZOO_F32_TOL = 1e-3
ZOO_TINY_P = 1e-30
# bf16 replies against the same rows called alone: a served step may pad
# them into another bucket, and the card rounds each op's output to bf16
# (2**-8 relative) in other places at other row counts (the CPU tests'
# bf16 limit)
ZOO_BF16_TOL = 0.05
# each reply row's probabilities sum to 1 within this (bf16 outputs: each
# probability rounded once, 2**-9 of the sum at most)
ZOO_SUM_TOL = 1e-2
ZOO_RESNET_REQUESTS = 24  # 16-row uint8 rawTensor requests, as bench.py sends
ZOO_BERT_REQUESTS = 16  # 64-row x 128-token int32 rawTensor requests
ZOO_BANDIT_REQUESTS = 32  # seed 7 explores branch 1 at the 21st, then exploits it


def _zoo_rows(family: str, cfg, rows: int, rng):
    """Seeded rows of a family's wire format: uint8 pixels (ResNet), token
    ids with rows 1-3 padded after 100, after 17 and from the start (BERT),
    pixels in [0, 1) (CNN, MLP)."""
    import numpy as np

    if family == "resnet":
        return rng.integers(0, 256, (rows, cfg.image_size, cfg.image_size, cfg.channels),
                            dtype=np.uint8)
    if family == "bert":
        ids = rng.integers(1, cfg.vocab_size, (rows, BERT_TOKENS), dtype=np.int32)
        if rows >= 4:
            ids[1, 100:] = ids[2, 17:] = ids[3, :] = cfg.pad_id
        return ids
    width = cfg.in_features if family == "mlp" else cfg.image_size ** 2 * cfg.channels
    return rng.random((rows, width), dtype=np.float32)


def _perturb(module, gen) -> None:
    """Draw every bias, norm scale and BatchNorm statistic (variance >= 0.5)
    from ``gen``: flax's initial values (zero biases, unit statistics,
    ``bn3`` at scale 0) would hide a wrong bias, statistic or residual."""
    import torch

    from seldon_core_tpu_torch.models import zoo

    def draw(t, mean, std):
        t.copy_(torch.randn(t.shape, generator=gen, device=t.device) * std + mean)

    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, zoo.BatchNorm):
                draw(mod.scale, 1.0, 0.2)
                draw(mod.bias, 0.0, 0.1)
                draw(mod.mean, 0.0, 0.1)
                mod.var.copy_(torch.rand(mod.var.shape, generator=gen, device=mod.var.device)
                              + 0.5)
            elif isinstance(mod, torch.nn.LayerNorm):
                draw(mod.weight, 1.0, 0.2)
                draw(mod.bias, 0.0, 0.1)
            elif isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d)) and mod.bias is not None:
                draw(mod.bias, 0.0, 0.1)


def _log_err(got, want) -> tuple[float, float]:
    """(largest |log got - log want| over the classes with want > ZOO_TINY_P,
    max(1, their largest |log want|))."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mask = want > ZOO_TINY_P
    err = np.abs(np.log(np.maximum(got[mask], 1e-300)) - np.log(want[mask]))
    return float(err.max()), float(max(1.0, np.abs(np.log(want[mask])).max()))


def _flops_per_row(module, x) -> float:
    """FLOPs of one row, counted from the shapes of the operations a
    one-row forward runs (``torch.utils.flop_counter``: 2 x the
    multiply-adds of every convolution and matrix product, BERT's
    attention products over every key included: the plain math masks, it
    does not skip)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        module(x[:1])
    return float(counter.get_total_flops())


def _zoo_times(model, x, iters: int = 20) -> dict:
    """At ``x``'s bucket (its rows fill it): device ms a step replayed from
    its graph (CUDA events around ``iters`` replays), eager ms a forward
    (CUDA events around ``iters`` eager forwards, their host launches
    included), host ms a dispatch (pinned copy, uploads, replay and
    download enqueued)."""
    import numpy as np
    import torch

    entry = model._graphs[(x.shape[0], tuple(x.shape[1:]), np.dtype(x.dtype).str)]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    entry["graph"].replay()
    _sync()
    start.record()
    for _ in range(iters):
        entry["graph"].replay()
    end.record()
    end.synchronize()
    replay_ms = start.elapsed_time(end) / iters
    xt = torch.from_numpy(x).cuda()
    model._forward(xt)
    _sync()
    start.record()
    for _ in range(iters):
        model._forward(xt)
    end.record()
    end.synchronize()
    eager = start.elapsed_time(end) / iters
    host, pending = 0.0, []
    for _ in range(iters):  # four steps in flight, fewer than the staging slots
        t0 = time.perf_counter()
        pending.append(model.dispatch(x))
        host += time.perf_counter() - t0
        if len(pending) > 4:
            model.fetch(*pending.pop(0))
    for h in pending:
        model.fetch(*h)
    host = host * 1e3 / iters
    return {"bucket": x.shape[0], "device_ms": replay_ms, "eager_ms": eager,
            "host_dispatch_ms": host, "rows_per_s": x.shape[0] / replay_ms * 1e3}


def _zoo_family(family: str, seed: int, device: str = "cuda") -> dict:
    """Z0 and Z1 for one family at full width, on seeded and perturbed
    weights: the card in float32 (TF32 off) against the CPU in float32 on
    ZOO_REF_ROWS rows; the card in bf16 (the served model, its buckets
    captured at warmup) against the same; for ResNet the uint8 ingest
    against the pixels normalized on the host; the largest bucket replayed
    against the eager forward from the same input (bit-equal) and timed."""
    import copy

    import numpy as np
    import torch

    from seldon_core_tpu_torch.executor.compiled import BucketSpec, CompiledModel
    from seldon_core_tpu_torch.models import registry, resnet

    preset = ZOO_PRESETS[family]
    fam = registry.get_family(family)
    cfg = registry.resolve_family_config(family, preset)
    gen = torch.Generator(device=device).manual_seed(seed)
    module = fam.init_params(cfg, gen, device=device)
    _perturb(module, gen)
    rng = np.random.default_rng(seed)
    x = _zoo_rows(family, cfg, ZOO_REF_ROWS, rng)
    rec: dict = {"preset": preset, "buckets": list(ZOO_BUCKETS[family])}
    # the served model first: warmup captures its buckets in the wire dtype
    served = CompiledModel(copy.deepcopy(module), buckets=BucketSpec(ZOO_BUCKETS[family]),
                           dtype=torch.bfloat16, name=f"{family}:{preset}", device=device)
    t0 = time.perf_counter()
    rec["warmup_buckets"] = served.warmup(x.shape[1:], x.dtype)
    rec["warmup_s"] = time.perf_counter() - t0
    rec["capture_s"] = [g["capture_s"] for g in served.program_snapshot()["graphs"]]
    cpu = copy.deepcopy(module).cpu()
    with torch.no_grad():
        want = cpu(torch.from_numpy(x)).float().numpy()
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f32 = CompiledModel(copy.deepcopy(module), buckets=BucketSpec((ZOO_REF_ROWS,)),
                            name=f"{family}:f32", device=device)
        got = f32(x)
        err, scale = _log_err(got, want)
        rec["f32"] = {"max_log_err": err, "log_scale": scale, "limit": ZOO_F32_TOL * scale,
                      "max_abs_err": float(np.abs(got - want).max()),
                      "finite": bool(np.isfinite(got).all()), "shape": list(got.shape)}
        if family == "resnet":
            norm = ((x.astype(np.float32) / 255.0 - np.float32(resnet.IMAGENET_MEAN))
                    / np.float32(resnet.IMAGENET_STD)).astype(np.float32)
            ingest, _ = _log_err(got, f32(norm))
            rec["uint8_ingest_vs_normalized"] = {"max_log_err": ingest,
                                                 "limit": ZOO_F32_TOL * scale}
        del f32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    got16 = served(x)
    err16, _ = _log_err(got16, want)
    rec["bf16_vs_cpu_f32"] = {"max_log_err": err16,
                              "max_abs_err": float(np.abs(got16 - want).max()),
                              "argmax_agree": float((got16.argmax(-1) == want.argmax(-1)).mean())}
    # Z1: the largest bucket replayed against the eager forward, same input
    big = _zoo_rows(family, cfg, served.buckets.max, rng)
    replayed = served(big)
    big_t = torch.from_numpy(big).to(device)
    eager = served._forward(big_t).cpu().numpy()
    rec["replay_bit_equal_eager"] = bool(np.array_equal(replayed, eager))
    rec["flops_per_row"] = _flops_per_row(served.module, big_t)
    if device == "cuda":
        rec["times"] = _zoo_times(served, big)
        rec["times"]["peak_share"] = (rec["flops_per_row"] * served.buckets.max
                                      / (rec["times"]["device_ms"] * 1e-3) / BF16_FLOPS)
    rec["captures_after_warmup"] = served.program_compiles - rec["warmup_buckets"]
    rec["gates"] = {
        "f32": rec["f32"]["finite"] and err <= ZOO_F32_TOL * scale,
        "replay_bit_equal_eager": rec["replay_bit_equal_eager"],
        "no_capture_after_warmup": rec["captures_after_warmup"] == 0,
    }
    if family == "resnet":
        rec["gates"]["uint8_ingest"] = ingest <= ZOO_F32_TOL * scale
    del served, cpu, module
    return rec


def _zoo_unit(name: str, family: str, rng: int, **extra) -> dict:
    """A ``JAX_MODEL`` node as bench.py's graphs declare it (bf16, seeded
    weights); ``extra`` adds graph parameters (name -> (value, type))."""
    params = {"family": (family, "STRING"), "preset": (ZOO_PRESETS[family], "STRING"),
              "dtype": ("bfloat16", "STRING"), "rng": (rng, "INT"), **extra}
    return {"name": name, "type": "MODEL", "implementation": "JAX_MODEL",
            "parameters": [{"name": k, "value": str(v), "type": t}
                           for k, (v, t) in params.items()]}


def _raw_body(arr) -> dict:
    import base64

    return {"rawTensor": {"shape": list(arr.shape), "dtype": arr.dtype.name,
                          "data": base64.b64encode(arr.tobytes()).decode()}}


def _raw_reply(reply: dict):
    import base64

    import numpy as np

    rt = reply["rawTensor"]
    return np.frombuffer(base64.b64decode(rt["data"]), rt["dtype"]).reshape(rt["shape"])


def _zoo_host_costs(body: dict, reply: dict, iters: int = 5) -> dict:
    """Host ms of one request's wire work, outside the engine (the served
    wave runs its clients in this process, so they share its interpreter):
    the client's JSON encode, the engine's decode to a Payload, the reply's
    encode."""
    from seldon_core_tpu_torch.contract.codec import payload_from_json, payload_to_dict

    def ms(fn):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        return (time.perf_counter() - t0) * 1e3 / iters, out

    encode, raw = ms(lambda: json.dumps(body).encode())
    decode, payload = ms(lambda: payload_from_json(raw))
    answer, _ = ms(lambda: json.dumps(payload_to_dict(payload.with_array(_raw_reply(reply)))))
    return {"request_bytes": len(raw), "client_encode": encode, "engine_decode": decode,
            "reply_encode": answer}


def _zoo_counts(comps: dict) -> dict:
    return {n: (c.queue.steps, c.queue.rows, c.model.host_syncs, c.model.program_compiles)
            for n, c in comps.items() if hasattr(c, "queue")}


def _zoo_served(name: str, replies, walls, wave_s: float, before: dict, after: dict,
                rows: int) -> dict:
    """One served graph's record: predictions/s, request p50/p99, rows a
    step, steps, syncs and captures over the wave."""
    import numpy as np

    steps = sum(after[n][0] - before[n][0] for n in after)
    step_rows = sum(after[n][1] - before[n][1] for n in after)
    syncs = sum(after[n][2] - before[n][2] for n in after)
    captures = sum(after[n][3] - before[n][3] for n in after)
    return {"graph": name, "requests": len(replies), "rows": rows,
            "status": sorted({c for c, _ in replies}),
            "predictions_per_s": rows / wave_s, "wave_s": wave_s,
            "request_p50_ms": float(np.percentile(walls, 50) * 1e3),
            "request_p99_ms": float(np.percentile(walls, 99) * 1e3),
            "steps": steps, "mean_rows_per_step": step_rows / max(1, steps),
            "host_syncs": syncs, "captures": captures}


def _zoo_close(got, want) -> bool:
    import numpy as np

    got = np.asarray(got, np.float64)
    err, _ = _log_err(got, want)
    return err <= ZOO_BF16_TOL and bool(np.all(np.abs(got.sum(-1) - 1.0) <= ZOO_SUM_TOL))


async def _zoo_waves(device: str) -> list[dict]:
    """Z2: the JAX bench's own graphs through the in-process engine."""
    import numpy as np

    rng = np.random.default_rng(11)
    resnet_cfg = _zoo_cfg("resnet")
    bert_cfg = _zoo_cfg("bert")
    images = [_zoo_rows("resnet", resnet_cfg, 16, rng) for _ in range(4)]
    tokens = [_zoo_rows("bert", bert_cfg, 64, rng) for _ in range(4)]
    out = []

    async def served(name, graph, drive):
        app, boot_s = await _boot(_graph_spec(graph), device)
        try:
            rec = await drive(app)
            rec["boot_and_warmup_s"] = boot_s
            rec["warmup_report"] = dict(app.warmup_report)
            out.append(rec)
        finally:
            await app.close()

    async def wave(app, bodies, arrays, direct, name):
        comps = dict(app.service.walker.iter_components())
        before = _zoo_counts(comps)
        t0 = time.perf_counter()
        replies, _, walls = await _graph_wave(app.port, bodies)
        wave_s = time.perf_counter() - t0
        rec = _zoo_served(name, replies, walls, wave_s, before, _zoo_counts(comps),
                          sum(len(arrays[i % len(arrays)]) for i in range(len(bodies))))
        want = [await asyncio.to_thread(direct, comps, a) for a in arrays]
        rec["equal_to_solo"] = sum(
            code == 200 and _zoo_close(_raw_reply(r), want[i % len(arrays)])
            for i, (code, r) in enumerate(replies))
        return rec, replies

    resnet_unit = dict(input_dtype=("uint8", "STRING"), buckets=("16,32", "STRING"),
                       max_batch=(32, "INT"), max_delay_ms=(3.0, "FLOAT"))
    bert_unit = dict(buckets=("64,256", "STRING"), max_batch=(256, "INT"),
                     max_delay_ms=(5.0, "FLOAT"), input_shape=(BERT_TOKENS, "STRING"))

    async def resnet_wave(app):
        bodies = [_raw_body(images[i % 4]) for i in range(ZOO_RESNET_REQUESTS)]
        rec, replies = await wave(app, bodies, images, lambda c, a: c["resnet"].model(a),
                                  "resnet50")
        rec["host_ms_a_request"] = _zoo_host_costs(bodies[0], replies[0][1])
        return rec

    async def bert_wave(app):
        bodies = [_raw_body(tokens[i % 4]) for i in range(ZOO_BERT_REQUESTS)]
        rec, _ = await wave(app, bodies, tokens, lambda c, a: c["bert"].model(a), "bert-base")
        return rec

    async def bandit(app):
        from seldon_core_tpu_torch.graph.units import EpsilonGreedy

        comps = dict(app.service.walker.iter_components())
        before = _zoo_counts(comps)
        ref = EpsilonGreedy(n_branches=2, epsilon=0.2, seed=7)
        branches, host, feedback, walls, served_rows = [], [], [], [], []
        t0 = time.perf_counter()
        for i in range(ZOO_BANDIT_REQUESTS):
            body = _raw_body(images[i % 4])
            t1 = time.perf_counter()
            code, raw = await asyncio.to_thread(_call, app.port, "/api/v0.1/predictions", body)
            walls.append(time.perf_counter() - t1)
            reply = json.loads(raw)
            b = reply.get("meta", {}).get("routing", {}).get("ab")
            h = ref.route(None, [])
            ref.send_feedback(None, [], 1.0 if h == 1 else 0.0, routing=h)
            branches.append(b)
            host.append(h)
            served_rows.append((code, b, i % 4, reply))
            fb = await asyncio.to_thread(_call, app.port, "/api/v0.1/feedback", {
                "request": body, "response": reply, "reward": 1.0 if b == 1 else 0.0})
            feedback.append(fb[0])
        wave_s = time.perf_counter() - t0
        rec = _zoo_served("epsilon_greedy_resnet50", [(c, r) for c, _, _, r in served_rows],
                          walls, wave_s, before, _zoo_counts(comps), 16 * ZOO_BANDIT_REQUESTS)
        want = {(b, i): await asyncio.to_thread(comps[f"r{b}"].model, images[i])
                for b in (0, 1) for i in range(4)}
        rec.update({
            "branches": branches, "host_only_branches": host,
            "feedback_status": sorted(set(feedback)),
            "router_pulls": comps["ab"].pulls.tolist(),
            "equal_to_solo": sum(code == 200 and b in (0, 1) and _zoo_close(_raw_reply(r),
                                                                            want[(b, i)])
                                 for code, b, i, r in served_rows)})
        return rec

    async def ensemble(app):
        bodies = [_raw_body(tokens[i % 4]) for i in range(8)]
        rec, replies = await wave(
            app, bodies, tokens,
            lambda c, a: (c["b0"].model(a).astype(np.float64) + c["b1"].model(a)) / 2,
            "outlier_ensemble_bert-base")
        rec["outlier_tags"] = sum(
            len(r.get("meta", {}).get("tags", {}).get("outlier_score", [])) == 64
            for _, r in replies)
        return rec

    await served("resnet50", _zoo_unit("resnet", "resnet", 0, **resnet_unit), resnet_wave)
    await served("bert-base", _zoo_unit("bert", "bert", 0, **bert_unit), bert_wave)
    bandit_graph = {
        "name": "ab", "type": "ROUTER", "implementation": "EPSILON_GREEDY",
        "parameters": [{"name": "n_branches", "value": "2", "type": "INT"},
                       {"name": "epsilon", "value": "0.2", "type": "FLOAT"},
                       {"name": "seed", "value": "7", "type": "INT"}],
        "children": [_zoo_unit("r0", "resnet", 0, **resnet_unit),
                     _zoo_unit("r1", "resnet", 1, **resnet_unit)]}
    await served("bandit", bandit_graph, bandit)
    ensemble_graph = {
        "name": "outlier", "type": "TRANSFORMER", "implementation": "MAHALANOBIS_OUTLIER",
        "children": [{"name": "ens", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
                      "children": [_zoo_unit("b0", "bert", 0, **bert_unit),
                                   _zoo_unit("b1", "bert", 1, **bert_unit)]}]}
    await served("ensemble", ensemble_graph, ensemble)
    return out


def _zoo_cfg(family: str):
    from seldon_core_tpu_torch.models import registry

    return registry.resolve_family_config(family, ZOO_PRESETS[family])


def phase_serve_zoo(device: str = "cuda") -> dict:
    """The predict path on the card: Z0 and Z1 per family (``_zoo_family``),
    then Z2, four served graphs (``_zoo_waves``).  Gates: Z0's float32 and
    uint8 checks, Z1's bit-equal replay and no capture after warmup; in Z2
    every reply 200, each row summing to 1, equal to its unit (or the mean
    of the two) called alone, ``meta.routing`` and the outlier tags there,
    the feedback walk reaching the router, one host sync a device step and
    no capture after warmup.  Returns the kernels' launches (the zoo runs
    neither)."""
    import gc

    import torch

    from seldon_core_tpu_torch.ops import _build

    _build.reset_launches()  # the zoo's run starts here
    families = {}
    for i, family in enumerate(("resnet", "bert", "cnn", "mlp")):
        families[family] = _zoo_family(family, seed=i, device=device)
        emit({"phase": "serve_zoo", "family": family, **families[family]})
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    graphs = asyncio.run(_zoo_waves(device))
    bandit = next(g for g in graphs if g["graph"].startswith("epsilon"))
    launches = dict(_build.LAUNCHES)
    gates = {f"{family}_{k}": v for family, r in families.items() for k, v in r["gates"].items()}
    for g in graphs:
        name = g["graph"]
        gates[f"{name}_status"] = g["status"] == [200]
        gates[f"{name}_equal_to_solo"] = g["equal_to_solo"] == g["requests"]
        gates[f"{name}_one_sync_a_step"] = g["host_syncs"] == g["steps"] > 0
        gates[f"{name}_no_capture"] = g["captures"] == 0
    gates["bandit_routing"] = (bandit["branches"] == bandit["host_only_branches"]
                               and set(bandit["branches"]) == {0, 1})
    gates["bandit_feedback"] = (bandit["feedback_status"] == [200]
                                and sum(bandit["router_pulls"]) == ZOO_BANDIT_REQUESTS)
    ensemble = next(g for g in graphs if g["graph"].startswith("outlier"))
    gates["outlier_tags"] = ensemble["outlier_tags"] == ensemble["requests"]
    rec = {"phase": "serve_zoo", "dtype": "bfloat16", "served": graphs,
           "zoo_launches": launches, "gates": gates, "ok": all(gates.values())}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"serve_zoo: gates {[k for k, v in gates.items() if not v]}")
    return launches


# -- the request planes: response tiers and QoS ----------------------------------

SEM_SIM = 0.95  # the semantic tier's threshold (SCT_SEMCACHE_SIM's default)
CACHE_META = {"tags": {"smoke": "cache"}}  # every serve_cache body carries it
HERD = 16  # identical concurrent requests on a cold cache
QOS_NEW = 64  # new tokens a serve_qos request asks for
QOS_CAP = 8  # SCT_QOS_MAX_INFLIGHT and SCT_QOS_MAX_QUEUE in Q1 and Q2
QOS_WAVE = 32  # Q1's concurrent requests
BROWNOUT_FLOOD = 24  # Q4: sheds beside the 8 admitted, 32 decisions in the window


def _tokens_of(reply: dict) -> list[int]:
    return json.loads(json.loads(reply["raw"])["strData"])["tokens"]


def _p50_ms(seconds) -> float | None:
    return 1e3 * statistics.median(seconds) if seconds else None


def _cache_body(prompt, max_new: int = MAX_NEW, spaced: bool = False) -> bytes:
    """A serve_cache request: compact, or with its keys in the other order
    and spaced otherwise (the same content address)."""
    body = {"meta": CACHE_META,
            "strData": json.dumps({"tokens": prompt, "max_new_tokens": max_new})}
    if spaced:
        return json.dumps(dict(reversed(list(body.items()))), indent=3).encode()
    return json.dumps(body, separators=(",", ":")).encode()


async def _until(cond, timeout_s: float = 60.0, what: str = "a condition") -> None:
    deadline = time.perf_counter() + timeout_s
    while not cond():
        if time.perf_counter() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.005)


async def _quiet(model, settle_s: float = 0.3) -> None:
    """Wait until no decode block is fetched for ``settle_s``: the overlap
    dispatches one block past a wave's last token, fetched after the
    replies went out."""
    while True:
        n = model.decode_blocks
        await asyncio.sleep(settle_s)
        if model.decode_blocks == n:
            return


def _cosines(port: int, prompts) -> list[list[float]]:
    """The pairwise cosines of the prompts' ``/api/v0.1/embeddings`` vectors."""
    import numpy as np

    reply = json.loads(_req(port, {"tokens": prompts}, path="/api/v0.1/embeddings")["raw"])
    v = _raw_reply(reply).astype(np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (v @ v.T).tolist()


def phase_serve_cache(serve: dict, device: str = "cuda", preset: str = SERVE_PRESET) -> dict:
    """The response tiers at llama3-1b width (``SCT_CACHE=1``,
    ``SCT_SEMCACHE=1``, ``embed`` on, the serve graph's seed): C1 the exact
    tier, C2 request collapsing, C3 the semantic tier, C4 the walker's node
    tier under a random router, C5 a sampled unit.  Returns the launch
    counts of the 1b engine's waves."""
    import numpy as np

    from seldon_core_tpu_torch.ops import _build

    prompts, want = serve["prompts"], serve["outs"]  # 8 distinct; a cache-off engine's streams
    rng = np.random.default_rng(10)
    planes = {"SCT_CACHE": "1", "SCT_SEMCACHE": "1"}

    async def llama() -> tuple[dict, dict]:
        app, boot_s = await _boot(_serve_spec(preset, 0, embed=("true", "BOOL")), device)
        port = app.port
        try:
            model = app.service.walker.component.model
            vocab = model.cfg.vocab_size
            counters = lambda: {"prefills": model.prefills, "steps": model.steps,  # noqa: E731
                                "decode_blocks": model.decode_blocks, "embeds": model.embeds}
            _build.reset_launches()
            # C1: the exact tier
            first = await _requests(port, [_cache_body(p) for p in prompts])
            await _quiet(model)
            before = counters()
            second = await _requests(port, [_cache_body(p, spaced=True) for p in prompts])
            # the same hits one at a time: no client thread waits on another
            serial = [await asyncio.to_thread(_req, port, _cache_body(p)) for p in prompts]
            after = counters()
            c1 = {"prompt_lens": [len(p) for p in prompts],
                  "first_status": [r["status"] for r in first],
                  "first_equal_to_cache_off": sum(
                      r["status"] == 200 and _tokens_of(r) == w for r, w in zip(first, want)),
                  "second_hits": sum(r["headers"].get("x-sct-cache") == "hit" for r in second),
                  "second_byte_equal": sum(a["raw"] == b["raw"] for a, b in zip(first, second)),
                  "counters_before": before, "counters_after": after,
                  "miss_p50_ms": _p50_ms([r["s"] for r in first]),
                  "hit_p50_ms": _p50_ms([r["s"] for r in second]),
                  "hit_serial_p50_ms": _p50_ms([r["s"] for r in serial])}
            c1["ok"] = (c1["first_equal_to_cache_off"] == len(prompts)
                        and c1["second_hits"] == c1["second_byte_equal"] == len(prompts)
                        and all(r["headers"].get("x-sct-cache") == "hit" for r in serial)
                        and before == after)
            # C2: a herd on a cold key (its own options: no semantic match)
            herd_prompt = rng.integers(0, vocab, 100).tolist()
            coll0, p0 = app.service.collapse.snapshot(), model.prefills
            herd = await _requests(port, [_cache_body(herd_prompt, max_new=24)] * HERD)
            coll1 = app.service.collapse.snapshot()
            c2 = {"status": sorted({r["status"] for r in herd}),
                  "distinct_replies": len({r["raw"] for r in herd}),
                  "prefills": model.prefills - p0,
                  "leaders": coll1["leaders"] - coll0["leaders"],
                  "followers": coll1["collapsed"] - coll0["collapsed"]}
            c2["ok"] = (c2["status"] == [200] and c2["distinct_replies"] == 1
                        and c2["prefills"] == c2["leaders"] == 1 and c2["followers"] == HERD - 1)
            # C3: the semantic tier, the exact tier flushed
            app.service.response_cache.flush()
            k1 = _build.LAUNCHES["flash_attention"]
            resend = await asyncio.to_thread(_req, port, _cache_body(prompts[3]))
            embed_k1 = _build.LAUNCHES["flash_attention"] - k1
            sem = app.service.semantic_cache.snapshot()
            unrelated = rng.integers(0, vocab, 64).tolist()
            t0 = time.perf_counter()
            cos = await asyncio.to_thread(_cosines, port, [unrelated] + list(prompts))
            embed_ms = 1e3 * (time.perf_counter() - t0) / (1 + len(prompts))
            best = max(cos[0][1:])
            other = await asyncio.to_thread(_req, port, _cache_body(unrelated))
            longer = await asyncio.to_thread(_req, port, _cache_body(prompts[3], max_new=48))
            launches = dict(_build.LAUNCHES)
            c3 = {"resend": resend["headers"].get("x-sct-cache"),
                  "resend_byte_equal": resend["raw"] == first[3]["raw"],
                  "last_sim": sem["last_similarity"],
                  "unrelated_best_cos": best,
                  "unrelated": other["headers"].get("x-sct-cache"),
                  "longer": longer["headers"].get("x-sct-cache"),
                  "longer_tokens": len(_tokens_of(longer)) if longer["status"] == 200 else None,
                  "longer_extends_the_stream": (longer["status"] == 200
                                                and _tokens_of(longer)[:MAX_NEW] == want[3]),
                  "k1_launches_per_embed": embed_k1, "embed_ms_per_prompt": embed_ms,
                  "semantic": app.service.semantic_cache.snapshot()}
            ambiguous = abs(best - SEM_SIM) < 1e-3  # the card's bf16 rows may land either side
            c3["ok"] = (c3["resend"] == "semantic" and c3["resend_byte_equal"]
                        and (c3["last_sim"] or 0) >= SEM_SIM
                        and (ambiguous or (c3["unrelated"] == "semantic") == (best >= SEM_SIM))
                        and other["status"] == 200 and c3["longer"] is None
                        and c3["longer_tokens"] == 48 and c3["longer_extends_the_stream"]
                        and (embed_k1 > 0 or device != "cuda"))
            return {"boot_and_warmup_s": boot_s, "C1": c1, "C2": c2, "C3": c3,
                    "stats_cache": app.service.cache_snapshot()}, launches
        finally:
            await app.close()

    async def node_tier() -> dict:
        graph = {"name": "ab", "type": "ROUTER", "implementation": "RANDOM_ABTEST",
                 "parameters": [{"name": "ratioA", "value": "0.5", "type": "FLOAT"}],
                 "children": [_zoo_unit(n, "mlp", i, buckets=(",".join(
                     map(str, ZOO_BUCKETS["mlp"])), "STRING")) for i, n in enumerate("ab")]}
        app, _ = await _boot(_graph_spec(graph), device)
        try:
            comps = dict(app.service.walker.iter_components())
            row = _zoo_rows("mlp", _zoo_cfg("mlp"), 1, rng)
            steps0 = {n: comps[n].queue.steps for n in "ab"}
            replies = [await asyncio.to_thread(_req, app.port, _raw_body(row)) for _ in range(12)]
            bodies = [json.loads(r["raw"]) for r in replies]
            paths = [b["meta"]["requestPath"] for b in bodies]
            served = [next(n for n in "ab" if n in p) for p in paths]
            cached = [p[n] == "cache" for p, n in zip(paths, served)]
            steps = {n: comps[n].queue.steps - steps0[n] for n in "ab"}
            rec = {"engine_tier_bound": app._resp_cache is not None,
                   "graph_deterministic": app.service.graph_deterministic(),
                   "served": served, "node_hits": sum(cached),
                   "first_of_each_computed": [not cached[served.index(n)] for n in set(served)],
                   "unit_steps": steps, "node": app.service.node_cache.snapshot(),
                   "replies_equal_per_unit": all(
                       b["rawTensor"] == bodies[served.index(n)]["rawTensor"]
                       for b, n in zip(bodies, served))}
            rec["ok"] = (not rec["engine_tier_bound"] and not rec["graph_deterministic"]
                         and rec["node_hits"] == len(replies) - len(set(served))
                         and all(rec["first_of_each_computed"])
                         and sum(steps.values()) == len(set(served))
                         and rec["replies_equal_per_unit"]
                         and all(r["status"] == 200 for r in replies))
            return rec
        finally:
            await app.close()

    async def sampled() -> dict:
        spec = _serve_spec(preset, 0, temperature=("0.8", "FLOAT"), n_layers=("2", "INT"),
                           embed=("true", "BOOL"))
        app, _ = await _boot(spec, device)
        try:
            replies = [await asyncio.to_thread(_req, app.port, _cache_body(prompts[1]))
                       for _ in range(2)]
            rec = {"engine_tier_bound": app._resp_cache is not None,
                   "semantic_tier_bound": app._sem_cache is not None,
                   "graph_deterministic": app.service.cache_snapshot()["graph_deterministic"],
                   "x_sct_cache": [r["headers"].get("x-sct-cache") for r in replies],
                   "status": [r["status"] for r in replies]}
            rec["ok"] = (not rec["engine_tier_bound"] and not rec["semantic_tier_bound"]
                         and rec["graph_deterministic"] is False
                         and rec["x_sct_cache"] == [None, None] and rec["status"] == [200, 200])
            return rec
        finally:
            await app.close()

    # the whole environment is put back on exit: only after every engine closed
    with unittest.mock.patch.dict(os.environ, planes):
        rec, launches = asyncio.run(llama())
        rec["C4"] = asyncio.run(node_tier())
        rec["C5"] = asyncio.run(sampled())
    rec.update(phase="serve_cache", preset=preset, dtype="bfloat16", launches=launches)
    rec["ok"] = all(rec[c]["ok"] for c in ("C1", "C2", "C3", "C4", "C5"))
    emit(rec)
    if not rec["ok"]:
        failed = [c for c in ("C1", "C2", "C3", "C4", "C5") if not rec[c]["ok"]]
        raise AssertionError(f"serve_cache: {failed} failed (see the record)")
    return launches


def _admission_us(qos, n: int = 20000) -> float:
    """Host microseconds of one admission decision and its release."""
    ctl = qos.AdmissionController("bench")
    t0 = time.perf_counter()
    for _ in range(n):
        ctl.admit().release()
    return 1e6 * (time.perf_counter() - t0) / n


def phase_serve_qos(serve: dict, device: str = "cuda", preset: str = SERVE_PRESET) -> dict:
    """Admission, priorities, deadlines and brownout at llama3-1b width (the
    serve graph with ``kv_prefix_reuse`` and ``prefill_chunk=256``), each of
    Q1-Q5 under its own controller built from ``SCT_QOS_*`` knobs, and the
    usage meter over the whole phase.  Returns the launch counts."""
    import numpy as np

    from seldon_core_tpu_torch import qos
    from seldon_core_tpu_torch.obs import METER, RECORDER, STAGE_DEVICE_STEP, STAGE_QUEUE_WAIT
    from seldon_core_tpu_torch.ops import _build

    rng = np.random.default_rng(11)
    spec = _serve_spec(preset, 0, kv_prefix_reuse=("true", "BOOL"),
                       prefill_chunk=(CACHED_CHUNK, "INT"))
    deadline, batch = qos.DEADLINE_HEADER, {qos.PRIORITY_HEADER: qos.PRIO_BATCH}

    async def run() -> tuple[dict, dict]:
        app, boot_s = await _boot(spec, device)
        port = app.port
        try:
            model = app.service.walker.component.model
            sched = app.service.walker.component.scheduler
            vocab = model.cfg.vocab_size
            ledger = {"sent": 0, "codes": {}, "delivered": 0}

            def use(**knobs):
                """A fresh controller from these SCT_QOS_* knobs."""
                app.qos = qos.AdmissionController.from_env(
                    app.service.deployment_name,
                    environ={f"SCT_QOS_{k}": str(v) for k, v in knobs.items()})
                qos.set_active_controller(app.qos)
                return app.qos

            async def send(bodies, headers=None) -> list[dict]:
                replies = await _requests(port, bodies, headers)
                for r in replies:
                    ledger["sent"] += 1
                    ledger["codes"][r["status"]] = ledger["codes"].get(r["status"], 0) + 1
                    if r["status"] == 200:
                        ledger["delivered"] += len(_tokens_of(r))
                return replies

            def prompt(n):
                return rng.integers(0, vocab, n).tolist()

            def body(p, max_new=QOS_NEW):
                return _body(p, max_new_tokens=max_new)

            admitted: list[int] = []  # prompt lengths, in the order they took a slot
            dispatch = model.admit_dispatch

            def logged(slot, p, *a, **kw):
                out = dispatch(slot, p, *a, **kw)
                admitted.append(len(p))  # once its prefill is counted
                return out

            model.admit_dispatch = logged
            METER.reset()
            _build.reset_launches()
            base = (model.block_seconds, model.decode_blocks, model.host_syncs)
            reaps0 = dict(sched.deadline_reaps)

            # Q1: the caps (half of 32 decisions shed is a brownout: Q4 holds
            # that, here it would clamp answers a shed left room for)
            ctl = use(MAX_INFLIGHT=QOS_CAP, MAX_QUEUE=QOS_CAP, BROWNOUT_SHED_RATE=1.01)
            q1_prompts = [prompt(n) for n in (24, 40, 56, 72, 88, 104, 120, 136)]
            wave = await send([body(p) for p in q1_prompts] * (QOS_WAVE // len(q1_prompts)))
            snap = ctl.snapshot()
            use()
            solo = {i: _tokens_of((await send([body(p)]))[0]) for i, p in enumerate(q1_prompts)}
            ok_replies = [(i % len(q1_prompts), r) for i, r in enumerate(wave)
                          if r["status"] == 200]
            q1 = {"status": {c: sum(r["status"] == c for r in wave) for c in (200, 429)},
                  "retry_after_min": min((int(r["headers"].get("retry-after", 0))
                                          for r in wave if r["status"] == 429), default=None),
                  "admitted_total": snap["admitted_total"], "shed_total": snap["shed_total"],
                  "equal_to_solo": sum(_tokens_of(r) == solo[i] for i, r in ok_replies)}
            q1["ok"] = (q1["status"][200] + q1["status"][429] == QOS_WAVE
                        and q1["status"][429] > 0 and (q1["retry_after_min"] or 0) >= 1
                        and snap["admitted_total"] + snap["shed_total"] == QOS_WAVE
                        and q1["equal_to_solo"] == len(ok_replies)
                        and all(len(solo[i]) == QOS_NEW for i in solo))

            # Q2: priority, every slot busy
            ctl = use(MAX_INFLIGHT=QOS_CAP, MAX_QUEUE=QOS_CAP)
            del admitted[:]
            holders = asyncio.ensure_future(send(
                [body(prompt(10 + i), 128 + SERVE_BLOCK * i) for i in range(SERVE_SLOTS)]))
            await _until(lambda: len(admitted) == SERVE_SLOTS, what="Q2's holders")
            batch_wave = asyncio.ensure_future(send(
                [body(prompt(40 + i), 8) for i in range(8)], [batch] * 8))
            await _until(lambda: ctl.admitted_total + ctl.shed_total == SERVE_SLOTS + 8,
                         what="Q2's batch decisions")
            await asyncio.sleep(0.05)  # the admitted batch requests reach the queue
            inter_wave = asyncio.ensure_future(send([body(prompt(60 + i), 8) for i in range(8)]))
            b_replies, i_replies, h_replies = (await batch_wave, await inter_wave, await holders)
            order = [n for n in admitted[SERVE_SLOTS:]]
            snap = ctl.snapshot()
            batch_cap = int(QOS_CAP * (1 - ctl.interactive_reserve))
            q2 = {"admission_order": order,
                  "batch_status": [r["status"] for r in b_replies],
                  "interactive_status": [r["status"] for r in i_replies],
                  "holders_status": sorted({r["status"] for r in h_replies}),
                  "shed_by_reason": snap["shed_by_reason"]}
            inter_pos = [i for i, n in enumerate(order) if n >= 60]
            batch_pos = [i for i, n in enumerate(order) if 40 <= n < 60]
            q2["ok"] = (q2["holders_status"] == [200]
                        and q2["batch_status"].count(429) == 8 - batch_cap
                        and q2["batch_status"].count(200) == batch_cap
                        and q2["interactive_status"].count(200) >= 1
                        and bool(inter_pos) and bool(batch_pos)
                        and max(inter_pos) < min(batch_pos))

            # Q3: deadlines (the predictive shed off: the 504s must come from queues)
            use(PREDICTIVE=0)
            del admitted[:]
            holders = asyncio.ensure_future(send(
                [body(prompt(12), 256) for _ in range(SERVE_SLOTS)]))
            await _until(lambda: len(admitted) == SERVE_SLOTS, what="Q3's holders")
            p0 = model.prefills
            doomed = (await send([body(prompt(30))], [{deadline: "1"}]))[0]
            qa = {"status": doomed["status"], "prefills": model.prefills - p0}
            await holders
            # (b) a deadline passing mid-decode beside seven greedy streams
            others = serve["prompts"][1:SERVE_SLOTS]
            late = prompt(50)
            blocks0, syncs0 = model.decode_blocks, model.host_syncs
            wave = await send([body(late, 512)] + [body(p) for p in others],
                              [{deadline: "1000"}] + [None] * len(others))
            wave_blocks, wave_syncs = model.decode_blocks - blocks0, model.host_syncs - syncs0
            solo_b = [_tokens_of((await send([body(p)]))[0]) for p in others]
            qb = {"status": [r["status"] for r in wave],
                  "others_equal_to_solo": sum(r["status"] == 200 and _tokens_of(r) == s
                                              for r, s in zip(wave[1:], solo_b)),
                  "blocks": wave_blocks, "host_syncs": wave_syncs}
            # (c) a deadline passing between the chunks of a 1900-token prompt
            long = prompt(1900)
            n0 = len(admitted)
            holders = asyncio.ensure_future(send([body(prompt(14), 256) for _ in range(2)]))
            await _until(lambda: len(admitted) == n0 + 2, what="Q3c's holders")
            chunks0 = model.prefill_chunks
            dropped = (await send([body(long, 32)], [{deadline: "250"}]))[0]
            chunks = model.prefill_chunks - chunks0
            await holders
            await _until(lambda: not sched._prefilling and not model._slot_blocks,
                         what="the pool to drain")
            pool = model.pool_snapshot()["blocks"]
            qc = {"status": dropped["status"], "chunks_dispatched": chunks,
                  "chunks_planned": -(-len(long) // CACHED_CHUNK),
                  "index_depth_of_the_dropped_prompt": model.prefix_index.peek_depth(
                      np.asarray(long, np.int32), len(long) // model.kv_block_size),
                  "blocks": pool}
            reaps = {k: v - reaps0.get(k, 0) for k, v in sched.deadline_reaps.items()}
            q3 = {"a": qa, "b": qb, "c": qc, "deadline_reaps": reaps}
            q3["ok"] = (qa["status"] == 504 and qa["prefills"] == 0
                        and qb["status"][0] == 504 and qb["status"][1:] == [200] * len(others)
                        and qb["others_equal_to_solo"] == len(others)
                        and qb["host_syncs"] == qb["blocks"]
                        and qc["status"] == 504 and 1 <= chunks < qc["chunks_planned"]
                        and qc["index_depth_of_the_dropped_prompt"] == 0
                        and pool["free"] + pool["prefix_index"] == pool["total"]
                        and reaps == {"generation-queue": 1, "decode": 1, "prefill": 1})

            # Q4: brownout (a short window and cooldown)
            ctl = use(MAX_INFLIGHT=QOS_CAP, MAX_QUEUE=0, BROWNOUT_WINDOW_S=2,
                      BROWNOUT_COOLDOWN_S=3, PREDICTIVE=0)
            holders = asyncio.ensure_future(send([body(prompt(16), 48)
                                                  for _ in range(QOS_CAP)]))
            await _until(lambda: ctl.admitted_total == QOS_CAP, what="Q4's holders")
            flood = await send([body(prompt(8), 8) for _ in range(BROWNOUT_FLOOD)])
            active = ctl.brownout_active
            await holders
            asked = prompt(20)
            clamped = (await send([body(asked, 64)]))[0]
            refused = (await send([body(prompt(9), 8)], [batch]))[0]
            snap = ctl.snapshot()
            await _until(lambda: not ctl.brownout_active, 10.0, "the brownout's cooldown")
            lifted = (await send([body(asked, 64)]))[0]
            q4 = {"decisions": snap["admitted_total"] + snap["shed_total"],
                  "flood_status": sorted({r["status"] for r in flood}),
                  "brownout_active": active, "entered_total": snap["brownout"]["entered_total"],
                  "clamped_tokens": len(_tokens_of(clamped)) if clamped["status"] == 200 else None,
                  "refused": (refused["status"], snap["shed_by_reason"].get("brownout")),
                  "lifted_tokens": len(_tokens_of(lifted)) if lifted["status"] == 200 else None}
            q4["ok"] = (active and q4["flood_status"] == [429]
                        and q4["decisions"] >= QOS_CAP + BROWNOUT_FLOOD
                        and q4["clamped_tokens"] == 16 and q4["refused"] == (429, 1)
                        and q4["lifted_tokens"] == 64
                        and _tokens_of(lifted)[:16] == _tokens_of(clamped))

            # Q5: the predictive shed, once both EWMAs hold samples
            ctl = use()
            est = ctl.snapshot()["predicted_completion_ms"]
            p0 = model.prefills
            budget = max(1.0, (est or 0.0) / 4)
            shed = (await send([body(prompt(22), 8)], [{deadline: f"{budget:.3f}"}]))[0]
            shed_prefills = model.prefills - p0
            roomy = (await send([body(prompt(22), 8)], [{deadline: "60000"}]))[0]
            q5 = {"predicted_completion_ms": est, "budget_ms": budget,
                  "status": shed["status"], "retry_after": shed["headers"].get("retry-after"),
                  "reason": ctl.snapshot()["shed_by_reason"], "prefills": shed_prefills,
                  "roomy_status": roomy["status"]}
            q5["ok"] = (est is not None and shed["status"] == 429
                        and q5["reason"] == {"predicted-slo-miss": 1} and shed_prefills == 0
                        and int(q5["retry_after"] or 0) >= 1 and roomy["status"] == 200)

            launches = dict(_build.LAUNCHES)
            model.admit_dispatch = dispatch
            # the meter over the phase: every request counted once; decode
            # tokens are the delivered ones less each started request's first
            # (its prefill's) plus the wasted; device seconds are the blocks'
            usage = METER.snapshot()["total"]
            n = {f: int(usage.get(f, 0)) for f in (
                "requests_completed", "requests_shed", "requests_reaped", "requests_cached",
                "tokens_decode", "tokens_wasted")}
            block_s = model.block_seconds - base[0]
            started = ledger["codes"].get(200, 0) + reaps.get("decode", 0)
            meter = {**n, "sent": ledger["sent"], "codes": ledger["codes"],
                     "delivered_200": ledger["delivered"], "started": started,
                     "device_s": usage.get("device_s", 0.0), "block_s": block_s}
            meter["ok"] = (n["requests_completed"] + n["requests_shed"] + n["requests_reaped"]
                           + n["requests_cached"] == ledger["sent"]
                           and n["tokens_decode"] + started
                           == ledger["delivered"] + n["tokens_wasted"]
                           and n["tokens_wasted"] > 0
                           and abs(meter["device_s"] - block_s) <= 0.01 * block_s)
            qw, step = RECORDER.stage_ewma(STAGE_QUEUE_WAIT), RECORDER.stage_ewma(STAGE_DEVICE_STEP)
            rec = {"phase": "serve_qos", "preset": preset, "dtype": "bfloat16",
                   "boot_and_warmup_s": boot_s, "Q1": q1, "Q2": q2, "Q3": q3, "Q4": q4,
                   "Q5": q5, "meter": meter,
                   "replies_429": ledger["codes"].get(429, 0),
                   "replies_504": ledger["codes"].get(504, 0),
                   "admission_us": _admission_us(qos),
                   "queue_wait_ewma_ms": 1e3 * qw if qw is not None else None,
                   "device_step_ewma_ms": 1e3 * step if step is not None else None,
                   "blocks": model.decode_blocks - base[1],
                   "host_syncs": model.host_syncs - base[2], "launches": launches}
            return rec, launches
        finally:
            qos.set_active_controller(None)
            await app.close()

    rec, launches = asyncio.run(run())
    parts = ("Q1", "Q2", "Q3", "Q4", "Q5", "meter")
    rec["ok"] = all(rec[p]["ok"] for p in parts) and rec["host_syncs"] == rec["blocks"]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"serve_qos: {[p for p in parts if not rec[p]['ok']]} failed "
                             "(see the record)")
    return launches


# -- serve_remote: remote graph nodes (wrapped microservices) --------------------------

REMOTE_READY_S = 90.0  # a child imports torch before it answers /ready
IRIS_REQUESTS = 64
IRIS_WAVE = 16  # concurrent clients in R1's wave
PIPELINE_REQUESTS = 16
C9_BOOTS = 8
# R3's root: a numpy router in its own process, persisted to a file store
SMOKE_ROUTER = '''\
class SmokeRouter:
    """strData (a prompt) to branch 0, numeric rows to branch 1; counts its
    routes and the rewards it is sent."""

    def __init__(self):
        self.routed = 0
        self.rewards = 0

    def route(self, X, names):
        self.routed += 1
        return 0 if isinstance(X, (str, bytes)) else 1

    def send_feedback(self, X, names, reward, truth=None, routing=None):
        self.rewards += 1

    def tags(self):
        return {"router_routed": self.routed, "router_rewards": self.rewards}
'''


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _connects(port: int) -> bool:
    import socket

    with socket.socket() as s:
        s.settimeout(1.0)
        return s.connect_ex(("127.0.0.1", port)) == 0


def _pct(xs, q: float) -> float:
    s = sorted(xs)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def _load_example(path: str, name: str):
    """An example's module, loaded by its file path (not as a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Children:
    """Microservices of the port's runtime CLI, one subprocess each on a
    free loopback port; every child is killed on exit."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.procs: dict = {}
        self.apis: dict = {}

    def start(self, name: str, interface: str, service_type: str, cwd: str,
              port: int | None = None, env: dict | None = None, persistence: int = 0,
              api: str = "REST") -> int:
        port = port or _free_port()
        log = open(os.path.join(self.logdir, f"{name}.log"), "ab")
        self.procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice", interface,
             api, "--service-type", service_type, "--port", str(port),
             "--persistence", str(persistence)],
            cwd=cwd, stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": ROOT, "PREDICTIVE_UNIT_ID": name, **(env or {})}),
            port, log)
        self.apis[name] = api
        return port

    def wait_ready(self, timeout_s: float = REMOTE_READY_S) -> float:
        t0 = time.perf_counter()
        waiting = set(self.procs)
        while waiting:
            for name in list(waiting):
                proc, port, _ = self.procs[name]
                if proc.poll() is not None:
                    raise AssertionError(f"microservice {name} exited with {proc.returncode}: "
                                         f"{self.tail(name)}")
                try:
                    # a gRPC child binds once its component is loaded
                    if (_connects(port) if self.apis[name] == "GRPC"
                            else _get(port, "/ready") == 200):
                        waiting.discard(name)
                except (urllib.error.URLError, OSError):
                    pass  # not listening yet
            if waiting and time.perf_counter() - t0 > timeout_s:
                raise AssertionError(f"microservices {sorted(waiting)} not ready in {timeout_s} s")
            time.sleep(0.1)
        return time.perf_counter() - t0

    def tail(self, name: str) -> str:
        with open(os.path.join(self.logdir, f"{name}.log"), "rb") as f:
            return f.read()[-2000:].decode(errors="replace")

    def stop(self, name: str) -> int:
        """SIGTERM (the runtime's graceful exit, its persistence flush
        included) -> the exit code."""
        proc, _, log = self.procs.pop(name)
        proc.terminate()
        try:
            return proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()

    def close(self) -> None:
        for name in list(self.procs):
            proc, _, log = self.procs.pop(name)
            proc.kill()
            proc.wait()
            log.close()


def _rest_node(name: str, port: int, unit_type: str, children=()) -> dict:
    return {"name": name, "type": unit_type, "children": list(children),
            "endpoint": {"service_host": "127.0.0.1", "service_port": port, "type": "REST"}}


async def _walls(port: int, bodies, clients: int) -> tuple[list, list]:
    """``bodies`` over ``clients`` concurrent clients -> (replies, walls)."""
    loop = asyncio.get_running_loop()
    with concurrent.futures.ThreadPoolExecutor(clients) as pool:
        got = await asyncio.gather(*(loop.run_in_executor(pool, _req, port, b) for b in bodies))
    return [(r["status"], json.loads(r["raw"])) for r in got], [r["s"] for r in got]


async def _traced_hops(app, bodies, node: str, inner: str | None = None) -> list[float]:
    """Each body walked alone with per-node timings -> ms of ``node`` less
    ``inner``'s (the engine's side of a remote hop)."""
    from seldon_core_tpu_torch.contract.codec import payload_from_dict

    out = []
    for b in bodies:
        t = (await app.service.walker.predict(payload_from_dict(b), trace=True)).meta.tags[
            "sct_trace_ms"]
        out.append(t[node] - (t[inner] if inner else 0.0))
    return out


async def _r1_iris(iris_port: int, iris, device: str) -> dict:
    """R1, BASELINE config 1: the Iris classifier behind the engine."""
    import urllib.parse

    import numpy as np

    from seldon_core_tpu_torch.obs import RECORDER, STAGE_ENGINE_ROUTE

    rng = np.random.default_rng(11)
    rows = [rng.uniform(0.1, 8.0, size=(int(rng.integers(1, 9)), 4)).round(3)
            for _ in range(IRIS_REQUESTS)]
    bodies = [{"data": {"names": ["sepal_length", "sepal_width", "petal_length", "petal_width"],
                        "ndarray": r.tolist()}} for r in rows]
    # examples/iris/seldondeployment.yaml's graph, its unit behind a REST endpoint
    app, boot_s = await _boot(_graph_spec(_rest_node("iris", iris_port, "MODEL")), device)
    try:
        pool = app.service.transports.pools[("127.0.0.1", iris_port)]
        one, one_walls = [], []
        for b in bodies:
            r = await asyncio.to_thread(_req, app.port, b)
            one.append((r["status"], json.loads(r["raw"])))
            one_walls.append(r["s"])
        # the engine's own time a request (parse, walk, reply bytes): the
        # rest of a client's wall is the client and the loopback front
        routes = list(RECORDER._stages[STAGE_ENGINE_ROUTE])[-len(bodies):]
        opened_one = pool.opened
        wave, wave_walls = await _walls(app.port, bodies, IRIS_WAVE)
        opened = pool.opened
        form = await asyncio.to_thread(
            _req, app.port, urllib.parse.urlencode({"json": json.dumps(bodies[0])}).encode(),
            {"Content-Type": "application/x-www-form-urlencoded"})
        hops = await _traced_hops(app, bodies[:16], "iris")
    finally:
        await app.close()
    host = iris.IrisClassifier()
    names = ["setosa", "versicolor", "virginica"]
    equal = sum(int(st == 200 and np.array_equal(np.asarray(rep["data"]["ndarray"]),
                                                 host.predict(r, []))
                    and rep["data"]["names"] == names)
                for (st, rep), r in zip(one + wave, rows + rows))
    form_reply = json.loads(form["raw"])
    rec = {"requests": 2 * len(bodies), "rows": [len(r) for r in rows], "equal_to_host": equal,
           "boot_s": boot_s,
           "one_at_a_time_ms_p50": 1e3 * _pct(one_walls, 0.5),
           "one_at_a_time_ms_p99": 1e3 * _pct(one_walls, 0.99),
           "engine_route_ms_p50": 1e3 * _pct(routes, 0.5),
           "wave_clients": IRIS_WAVE, "wave_ms_p50": 1e3 * _pct(wave_walls, 0.5),
           "wave_ms_p99": 1e3 * _pct(wave_walls, 0.99),
           "pool_opened_one_at_a_time": opened_one, "pool_opened": opened,
           "hop_ms_p50": _pct(hops, 0.5), "form_status": form["status"],
           "form_equal": form_reply.get("data") == one[0][1]["data"]}
    rec["ok"] = (equal == 2 * len(bodies) and opened_one == 1 and opened <= IRIS_WAVE
                 and form["status"] == 200 and rec["form_equal"])
    return rec


async def _r2_pipeline(ports: dict, pipe, graph_file: dict, device: str) -> dict:
    """R2: examples/transform-pipeline/graph.json, its ports the children's."""
    import numpy as np

    def rewrite(node):
        return {**node, "endpoint": {**node["endpoint"], "service_port": ports[node["name"]]},
                "children": [rewrite(c) for c in node.get("children", [])]}

    rng = np.random.default_rng(12)
    rows = [rng.uniform(0.1, 8.0, size=(int(rng.integers(1, 9)), 4)).round(3)
            for _ in range(PIPELINE_REQUESTS)]
    app, boot_s = await _boot(_graph_spec(rewrite(graph_file["graph"])), device)
    try:
        replies, walls = await _walls(app.port, [{"data": {"ndarray": r.tolist()}} for r in rows],
                                      4)
    finally:
        await app.close()
    want = [pipe.ArgmaxLabel().transform_output(
        pipe.Scorer().predict(pipe.Standardize().transform_input(r, []), []), []) for r in rows]
    equal = sum(int(st == 200 and np.array_equal(np.asarray(rep["data"]["ndarray"]), w))
                for (st, rep), w in zip(replies, want))
    paths = replies[0][1].get("meta", {}).get("requestPath", {})
    rec = {"requests": len(rows), "equal_to_composition": equal, "boot_s": boot_s,
           "wall_ms_p50": 1e3 * _pct(walls, 0.5), "request_path": sorted(paths)}
    rec["ok"] = equal == len(rows) and rec["request_path"] == ["label", "scorer", "standardize"]
    return rec


async def _r3_router(kids: "_Children", router_port: int, router_dir: str, router_env: dict,
                     serve: dict, device: str, preset: str) -> tuple[dict, dict]:
    """R3: a remote router in front of llama3-1b on the card."""
    from seldon_core_tpu_torch.ops import _build
    from seldon_core_tpu_torch.runtime import persistence

    graph = _rest_node("router", router_port, "ROUTER", children=[
        _gen_node("gen", preset, 0, seq_impl=("flash", "STRING")),
        {"name": "simple", "type": "MODEL", "implementation": "SIMPLE_MODEL"}])
    prompts, want = serve["prompts"], serve["outs"]  # 8 distinct; the serve phase's streams
    bodies = [_body(p) for p in prompts]
    app, boot_s = await _boot(_graph_spec(graph), device)
    try:
        comp = dict(app.service.walker.iter_components())["gen"]
        _build.reset_launches()  # this phase's main-path run starts here
        replies, _, _ = await _graph_wave(app.port, bodies)
        launches = dict(_build.LAUNCHES)  # and ends here
        direct = await _direct(comp, bodies)
        streams = [json.loads(r["strData"])["tokens"] if st == 200 else None
                   for st, r in replies]
        fb = [await asyncio.to_thread(_call, app.port, "/api/v0.1/feedback",
                                      {"request": b, "response": r, "reward": 1.0})
              for b, (_, r) in zip(bodies, replies)]
        numeric = {"data": {"ndarray": [[1.0, 2.0]]}}
        after = json.loads((await asyncio.to_thread(_req, app.port, numeric))["raw"])
        hops = await _traced_hops(app, bodies, "router", "gen")
        # the router restarts: a graceful stop flushes its state, a new process restores it
        rc = kids.stop("router")
        state = persistence.FileStateStore(router_env["PERSISTENCE_STORE"][len("file:"):]).get(
            persistence.state_key("router"))
        kids.start("router", "SmokeRouter", "ROUTER", router_dir, port=router_port,
                   env=router_env, persistence=1)
        kids.wait_ready()
        restarted = await asyncio.to_thread(_req, app.port, numeric)
    finally:
        await app.close()
    again = json.loads(restarted["raw"])
    rec = {"boot_s": boot_s, "requests": len(bodies),
           "routing": [r.get("meta", {}).get("routing", {}).get("router") for _, r in replies],
           "streams_equal_serve": _streams_equal(want, streams),
           "streams_equal_direct": sum(int(st == 200 and r["strData"] == d)
                                       for (st, r), d in zip(replies, direct)),
           "feedback_status": sorted({s for s, _ in fb}),
           "router_rewards_after_feedback": after["meta"]["tags"].get("router_rewards"),
           "router_exit_code": rc, "state_bytes": len(state or b""),
           "restarted_status": restarted["status"],
           "router_rewards_after_restart": again.get("meta", {}).get("tags", {}).get(
               "router_rewards"),
           "hop_ms_p50": _pct(hops, 0.5), "hop_ms": hops, "launches": launches}
    rec["ok"] = (rec["routing"] == [0] * len(bodies) and rec["streams_equal_serve"] == len(bodies)
                 and rec["streams_equal_direct"] == len(bodies) and rec["feedback_status"] == [200]
                 and rec["router_rewards_after_feedback"] == len(bodies) and rc == 0
                 and rec["state_bytes"] > 0 and restarted["status"] == 200
                 and rec["router_rewards_after_restart"] == len(bodies)
                 and all(n > 0 for n in launches.values()))
    return rec, launches


def _c9_capture_loop(device: str, preset: str, boots: int = C9_BOOTS) -> dict:
    """ROADMAP C9's pin: ``serve_cache``'s C5 unit (2 layers at llama3-1b
    width, temperature 0.8, embed on) booted and warmed ``boots`` times, the
    engine before it closed and dropped while the new one captures its
    decode graphs (after its first capture): a closed engine's objects are
    garbage while another engine captures.  The collector's existing
    objects are frozen and its thresholds lowered meanwhile, so that full
    collections run often (one once ran inside a capture, on the capturing
    thread, and destroyed a closed engine's graphs there; ``torch.cuda.graph``
    no longer collects before a capture)."""
    import gc

    from seldon_core_tpu_torch.engine.app import EngineApp
    from seldon_core_tpu_torch.engine.service import PredictionService

    spec = _serve_spec(preset, 0, temperature=("0.8", "FLOAT"), n_layers=("2", "INT"),
                       embed=("true", "BOOL"))
    out = {"boots": 0, "captures": 0, "closed_during_capture": 0, "failures": []}

    async def boot_while_closing(held: list) -> None:
        """Boot the next engine; once it has captured a graph, close the one
        in ``held`` and drop the last reference to it (it becomes garbage
        while the new one captures); then hold the new one."""
        app = EngineApp(PredictionService(spec, device=device))
        await app.start("127.0.0.1", 0)
        boot = asyncio.create_task(app.boot())
        try:
            if held:
                while not boot.done():  # until the new unit has captured a graph
                    walker = app.service.walker
                    if walker is not None and walker.component.model.program_compiles >= 1:
                        break
                    await asyncio.sleep(0.002)
                out["closed_during_capture"] += int(not boot.done())
                await held.pop().close()
            await boot
        except BaseException:
            boot.cancel()
            await app.close()
            raise
        out["captures"] += app.service.walker.component.model.program_compiles
        r = await asyncio.to_thread(_req, app.port, {"strData": json.dumps(
            {"tokens": VERIFY_PROMPT, "max_new_tokens": MAX_NEW})})
        if r["status"] != 200:
            await app.close()
            raise AssertionError(f"the sampled unit answered {r['status']}")
        held.append(app)

    async def run() -> None:
        held: list = []
        try:
            for _ in range(boots):
                try:
                    await boot_while_closing(held)
                except Exception as e:  # noqa: BLE001 - counted: the pin fails below
                    out["failures"].append(f"{type(e).__name__}: {e}"[:300])
                out["boots"] += 1
        finally:
            for app in held:
                await app.close()

    threshold = gc.get_threshold()
    gc.freeze()
    gc.collect()  # the long-lived count is the unfrozen survivors: full collections run
    gc.set_threshold(100, 2, 2)
    try:
        with unittest.mock.patch.dict(os.environ, {"SCT_CACHE": "1", "SCT_SEMCACHE": "1"}):
            asyncio.run(run())
    finally:
        gc.set_threshold(*threshold)
        gc.unfreeze()
    ok_boots = boots - len(out["failures"])
    out["captures_per_boot"] = out["captures"] / max(1, ok_boots)
    # no capture failed, and every engine but the first closed while the next captured
    out["ok"] = (not out["failures"] and out["captures"] > 0
                 and out["closed_during_capture"] == boots - 1)
    return out


def phase_serve_remote(serve: dict, device: str = "cuda", preset: str = SERVE_PRESET) -> dict:
    """Remote graph nodes: wrapped microservices of the port's runtime, each
    a subprocess on a free loopback port, behind the in-process engine.  R1
    the Iris classifier (BASELINE config 1), R2 the transform pipeline, R3 a
    persisted remote router in front of llama3-1b on the card; then ROADMAP
    C9's capture loop.  Returns R3's launch counts."""
    import tempfile

    iris_dir = os.path.join(ROOT, "examples", "iris")
    pipe_dir = os.path.join(ROOT, "examples", "transform-pipeline")
    iris = _load_example("examples/iris/IrisClassifier.py", "iris_example")
    pipe = _load_example("examples/transform-pipeline/pipeline.py", "pipeline_example")
    with open(os.path.join(pipe_dir, "graph.json")) as f:
        graph_file = json.load(f)
    rec: dict = {"phase": "serve_remote"}
    with tempfile.TemporaryDirectory(prefix="sct-remote-") as tmp:
        with open(os.path.join(tmp, "SmokeRouter.py"), "w") as f:
            f.write(SMOKE_ROUTER)
        router_env = {"PERSISTENCE_STORE": f"file:{os.path.join(tmp, 'state')}",
                      "PERSISTENCE_FREQUENCY": "3600"}
        kids = _Children(tmp)
        try:
            iris_port = kids.start("iris", "IrisClassifier", "MODEL", iris_dir)
            ports = {name: kids.start(name, f"pipeline.{cls}", kind, pipe_dir)
                     for name, cls, kind in (("standardize", "Standardize", "TRANSFORMER"),
                                             ("scorer", "Scorer", "MODEL"),
                                             ("label", "ArgmaxLabel", "TRANSFORMER"))}
            router_port = kids.start("router", "SmokeRouter", "ROUTER", tmp, env=router_env,
                                     persistence=1)
            rec["children_ready_s"] = kids.wait_ready()

            async def run() -> tuple:
                r1 = await _r1_iris(iris_port, iris, device)
                r2 = await _r2_pipeline(ports, pipe, graph_file, device)
                r3, launches = await _r3_router(kids, router_port, tmp, router_env, serve,
                                                device, preset)
                return r1, r2, r3, launches

            rec["R1"], rec["R2"], rec["R3"], launches = asyncio.run(run())
        finally:
            kids.close()
    rec["C9"] = _c9_capture_loop(device, preset)
    parts = ("R1", "R2", "R3", "C9")
    rec["ok"] = all(rec[p]["ok"] for p in parts)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"serve_remote: {[p for p in parts if not rec[p]['ok']]} failed "
                             "(see the record)")
    return launches


PACK_SLO_MS = 50  # chat's queue-wait SLO band on the packed card
PACK_BULK_SEED = 1  # bulk's weights: its own seed
PACK_TOP_K = 40  # bulk's top-k (its greedy requests are argmax all the same)
PACK_BULK_NEW = 256
PACK_BULK_LENS = (64, 100, 160, 211, 256, 333, 420, 512)
PACK_BURST = 16  # chat clients in a burst
PACK_BURST_LENS = (32, 256)  # a burst prompt's length: uniform in this range
PACK_BURST_NEW = 32
PACK_PAIR_SEED = 4242  # the seeded top-k pair's seed counter
PACK_PAIR_TEMP = 0.8
PACK_PAIR_LENS = (96, 200)
PACK_MID = 64  # a burst starts once every bulk stream has this many tokens
PACK_DRAIN_NEW = 256  # P2-P4's chat streams
PACK_DRAIN_LENS = (40, 64, 100, 128, 160, 200, 256, 300)


def _card() -> str:
    """The card's ``name, power limit`` as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi: {smi.stderr.strip()}"


def _rate(stamps, t0: float, t1: float) -> float | None:
    """Tokens a second delivered in ``[t0, t1)`` (``stamps``: delivery times)."""
    n = sum(t0 <= t < t1 for t in stamps)
    return n / (t1 - t0) if t1 > t0 and n else None


async def _bulk_wave(sched, prompts, stamps=None, seed=None, temperature=0.0) -> list:
    """``prompts`` submitted together to ``sched`` (the engine's loop), each
    token's delivery time appended to ``stamps``; returns the tasks."""
    import numpy as np

    if seed is not None:
        sched._seed = seed

    def hook(_tok):
        if stamps is not None:
            stamps.append(time.perf_counter())

    return [asyncio.ensure_future(sched.submit(
        np.asarray(p, np.int32), max_new_tokens=PACK_BULK_NEW, temperature=temperature,
        on_token=hook)) for p in prompts]


async def _cool(chat_sched, arb) -> None:
    """Wait until chat's pressure is under the resume floor and let the
    arbiter lift a preemption, so a bulk wave starts unpreempted."""
    await _until(lambda: chat_sched.queue_pressure() * 1e3 < PACK_SLO_MS * arb.low, 60.0,
                 "chat's pressure to cool")
    arb.poll()


def _ttfts_since(sched, n0: int) -> list[float]:
    return [t for _, t in list(sched.ttft)[n0:]]


async def _burst(port: int, prompts) -> tuple[list, float, float]:
    """``prompts`` posted concurrently to chat: (replies, start, end)."""
    t0 = time.perf_counter()
    replies = await _requests(port, [_body(p, max_new_tokens=PACK_BURST_NEW) for p in prompts])
    return replies, t0, time.perf_counter()


async def _drain_wave(a, peer_port: int | None, prompts, body: dict, want) -> dict:
    """P2-P4: chat streams live on ``a``, then ``/admin/drain`` with ``body``
    (and, with no peer, a repeat and ``/admin/undrain``); every reply must
    equal its uninterrupted stream ``want``."""
    model = a.service.walker.component.model
    sched = a.service.walker.component.scheduler
    blocks0, n0 = model.decode_blocks, len(sched.ttft)
    wave = asyncio.ensure_future(_requests(a.port, [_body(p, max_new_tokens=PACK_DRAIN_NEW)
                                                    for p in prompts]))
    # every stream has its first token, and two blocks more went by
    await _until(lambda: len(sched.ttft) - n0 >= len(prompts)
                 and model.decode_blocks - blocks0 >= 2, what="the chat streams to decode")
    code, raw = await asyncio.to_thread(_call, a.port, "/admin/drain", body)
    rec = {"drain_status": code, "drain": json.loads(raw)}
    if peer_port is None:
        code, raw = await asyncio.to_thread(_call, a.port, "/admin/drain", {})
        rec["repeat_status"], rec["repeat_phase"] = code, json.loads(raw).get(
            "drain", {}).get("phase")
        await asyncio.sleep(0.2)
        rec["held"] = not wave.done()
        code, raw = await asyncio.to_thread(_call, a.port, "/admin/undrain", {})
        rec["undrain_status"] = code
    replies = await wave
    got = [_tokens_of(r) if r["status"] == 200 else None for r in replies]
    rec["equal"] = sum(g == w for g, w in zip(got, want))
    await _quiet(model)
    rec["free_blocks"] = [model.free_block_count, model.kv_blocks - 1]
    rec["packing"] = sched.packing_snapshot()
    return rec


def phase_serve_pack(device: str = "cuda", preset: str = SERVE_PRESET) -> dict:
    """Chip packing and live drain at llama3-1b width.  P1: one engine, the
    primary ``chat`` (interactive, ``pack_slo_ms`` 50) and, through
    ``ENGINE_CO_PREDICTORS``, ``bulk`` (``pack_class=batch``, its own
    seed); a chat burst mid-way through a bulk wave preempts bulk, which
    resumes bit-exactly.  P2: ``/admin/drain`` to a peer engine moves 8 live
    chat streams.  P3: the same with ``disagg.handoff.send:torn:only=1``.
    P4: a drain with no peer parks, a repeat is a 409, ``/admin/undrain``
    resumes.  Returns the phase's launch counts."""
    import base64

    import numpy as np

    from seldon_core_tpu_torch import chaos
    from seldon_core_tpu_torch.engine.service import PredictionService, load_co_predictor_specs
    from seldon_core_tpu_torch.executor.arbiter import get_arbiter
    from seldon_core_tpu_torch.ops import _build

    rng = np.random.default_rng(12)
    from seldon_core_tpu_torch.graph.spec import PredictorSpec
    from seldon_core_tpu_torch.models.registry import resolve_config

    chat_spec = _serve_spec(preset, 0, name="chat", pack_slo_ms=(PACK_SLO_MS, "FLOAT"))
    bulk_dict = _serve_spec_dict(preset, PACK_BULK_SEED, name="bulk",
                                 pack_class=("batch", "STRING"), top_k=(PACK_TOP_K, "INT"))
    bulk_spec = PredictorSpec.from_dict(bulk_dict)
    rec: dict = {"phase": "serve_pack", "card": _card(), "preset": preset, "dtype": "bfloat16",
                 "n_slots": SERVE_SLOTS, "decode_block": SERVE_BLOCK}
    bulk_reference: list = []  # bulk's prompts and sole-engine streams, for serve_checkpoint

    async def run() -> dict:
        vocab = resolve_config(preset).vocab_size

        def prompts(lengths):
            return [rng.integers(0, vocab, n).tolist() for n in lengths]

        bulk_prompts = prompts(PACK_BULK_LENS)
        pair = prompts(PACK_PAIR_LENS)
        lo, hi = PACK_BURST_LENS
        bursts = [prompts(rng.integers(lo, hi + 1, PACK_BURST)) for _ in range(3)]
        drain_prompts = prompts(PACK_DRAIN_LENS)
        # the sole bulk unit: the uninterrupted streams
        ref, _ = await _boot(bulk_spec, device)
        try:
            rsched = ref.service.walker.component.scheduler
            want_bulk = [o.tolist() for o in await asyncio.gather(*await _bulk_wave(
                rsched, bulk_prompts))]
            want_pair = [o.tolist() for o in await asyncio.gather(*await _bulk_wave(
                rsched, pair, seed=PACK_PAIR_SEED, temperature=PACK_PAIR_TEMP))]
        finally:
            await ref.close()
        # P2-P4's peer, with chat's weights, and the drain streams'
        # uninterrupted runs on it: booted and run before the phase's count
        # starts, as the sole bulk unit is
        peer, _ = await _boot(chat_spec, device)
        a = None
        try:
            want = _check_replies(
                [(r["status"], json.loads(r["raw"])) for r in await _requests(
                    peer.port, [_body(p, max_new_tokens=PACK_DRAIN_NEW)
                                for p in drain_prompts])],
                drain_prompts, vocab, PACK_DRAIN_NEW)
            os.environ["ENGINE_CO_PREDICTORS"] = base64.b64encode(json.dumps(
                [bulk_dict]).encode()).decode()
            try:
                co = [PredictionService(s, device=device) for s in load_co_predictor_specs()]
            finally:
                del os.environ["ENGINE_CO_PREDICTORS"]
            a, boot_s = await _boot(chat_spec, device, co_services=co)
            chat = a.service.walker.component
            bulk = co[0].walker.component
            cm, bm = chat.model, bulk.model
            cs, bs = chat.scheduler, bulk.scheduler
            arb = get_arbiter()
            warm = (cm.program_compiles, bm.program_compiles)
            _build.reset_launches()  # the phase's main path starts here
            base = {m: (m.decode_blocks, m.host_syncs) for m in (cm, bm)}
            suspend_ms, frame_bytes = [], []
            susp, park = bs._suspend_active, bs._park_record

            async def timed_suspend(*args):
                t0 = time.perf_counter()
                n = await susp(*args)
                if n:
                    suspend_ms.append(1e3 * (time.perf_counter() - t0) / n)
                return n

            def logged_park(req, frame):
                frame_bytes.append(len(frame))
                return park(req, frame)

            bs._suspend_active, bs._park_record = timed_suspend, logged_park
            # P1: chat alone (bulk resident, idle), then mid-way through a bulk wave
            n0 = len(cs.ttft)
            await _burst(a.port, bursts[0])
            ttft_alone = _ttfts_since(cs, n0)
            await _cool(cs, arb)
            stamps: list = []
            p0 = (arb.preemptions, arb.resumes)
            tasks = await _bulk_wave(bs, bulk_prompts, stamps)
            await _until(lambda: len(stamps) >= PACK_MID * len(bulk_prompts), 120.0,
                         "the bulk wave to reach its middle")
            n0 = len(cs.ttft)
            replies, t_b0, t_b1 = await _burst(a.port, bursts[1])
            ttft_packed = _ttfts_since(cs, n0)
            got_bulk = [o.tolist() for o in await asyncio.gather(*tasks)]
            t_end = max(stamps)
            # bulk resumes once chat's pressure decays under the floor
            t_back = min((t for t in stamps if t >= t_b1), default=t_end)
            p1 = {"preemptions": arb.preemptions - p0[0], "resumes": arb.resumes - p0[1],
                  "burst_ok": sum(r["status"] == 200 for r in replies),
                  "bulk_equal": sum(g == w for g, w in zip(got_bulk, want_bulk)),
                  "chat_ttft_ms_alone": {"p50": 1e3 * _pct(ttft_alone, 0.5),
                                         "p99": 1e3 * _pct(ttft_alone, 0.99)},
                  "chat_ttft_ms_packed": {"p50": 1e3 * _pct(ttft_packed, 0.5),
                                          "p99": 1e3 * _pct(ttft_packed, 0.99)},
                  "bulk_tokens_per_s": {"before": _rate(stamps, min(stamps), t_b0),
                                        "during": _rate(stamps, t_b0, t_b1),
                                        "after": _rate(stamps, t_b1, t_end + 1e-9),
                                        "after_resumed": _rate(stamps, t_back, t_end + 1e-9)},
                  "burst_s": t_b1 - t_b0, "resume_wait_s": t_back - t_b1}
            # the seeded top-k pair, preempted the same way: its own
            # suspends and resumes are counted apart from the wave's
            await _cool(cs, arb)
            snap0 = bs.packing_snapshot()
            stamps2: list = []
            tasks = await _bulk_wave(bs, pair, stamps2, seed=PACK_PAIR_SEED,
                                     temperature=PACK_PAIR_TEMP)
            await _until(lambda: len(stamps2) >= PACK_MID * len(pair), 120.0,
                         "the pair to reach its middle")
            await _burst(a.port, bursts[2])
            got_pair = [o.tolist() for o in await asyncio.gather(*tasks)]
            await _quiet(bm)
            snap = bs.packing_snapshot()
            p1.update({
                "pair_equal": sum(g == w for g, w in zip(got_pair, want_pair)),
                "pair_differs_from_greedy": got_pair[0] != want_bulk[0],
                "pair_suspends": snap["suspends"] - snap0["suspends"],
                "pair_resumes": snap["resumes"] - snap0["resumes"],
                "suspends": snap["suspends"], "resumes_bulk": snap["resumes"],
                "suspend_ms_per_slot_mean": (statistics.mean(suspend_ms)
                                             if suspend_ms else None),
                "suspend_bytes_per_slot_mean": (statistics.mean(frame_bytes)
                                                if frame_bytes else None),
                "store_bytes": snap["suspend_store"]["bytes"] if snap["suspend_store"] else 0,
                "suspend_dram": (bm.memory_snapshot()["host"] or {}).get("suspend_dram", 0),
                "arbiter": arb.snapshot(),
                "arbiter_yield": {"chat": cs.overlap_breaks["arbiter-yield"],
                                  "bulk": bs.overlap_breaks["arbiter-yield"]},
                "captures_after_warmup": [cm.program_compiles - warm[0],
                                          bm.program_compiles - warm[1]],
                "syncs_per_block": [(m.host_syncs - base[m][1])
                                    / max(1, m.decode_blocks - base[m][0]) for m in (cm, bm)],
            })
            p1["ok"] = (p1["preemptions"] >= 1 and p1["suspends"] >= 1
                        and p1["resumes_bulk"] == p1["suspends"]
                        and p1["store_bytes"] == 0 and p1["suspend_dram"] == 0
                        and p1["bulk_equal"] == len(bulk_prompts)
                        and p1["pair_equal"] == len(pair) and p1["burst_ok"] == PACK_BURST
                        and p1["pair_suspends"] >= len(pair)
                        and p1["pair_resumes"] == p1["pair_suspends"]
                        and p1["captures_after_warmup"] == [0, 0]
                        and p1["syncs_per_block"] == [1.0, 1.0])
            rec["boot_and_warmup_s"], rec["P1"] = boot_s, p1
            # P2-P4: chat streams drained to the peer
            target = {"peer": f"127.0.0.1:{peer.port}", "timeout_s": 120}
            p2 = await _drain_wave(a, peer.port, drain_prompts, target, want)
            p2["ok"] = (p2["drain_status"] == 200 and p2["drain"]["migrated"] == 8
                        and p2["drain"]["failed"] == 0 and p2["equal"] == 8
                        and p2["free_blocks"][0] == p2["free_blocks"][1])
            chaos.configure("disagg.handoff.send:torn:only=1")
            try:
                p3 = await _drain_wave(a, peer.port, drain_prompts, target, want)
                code, raw = await asyncio.to_thread(_call, a.port, "/stats/chaos", None)
                p3["chaos"] = json.loads(raw)["chaos"]
            finally:
                chaos.reset()
            p3["ok"] = (p3["drain_status"] == 200 and p3["drain"]["migrated"] == 7
                        and p3["drain"]["failed"] == 1 and p3["equal"] == 8
                        and p3["chaos"]["fired"] == {"disagg.handoff.send": 1}
                        and p3["free_blocks"][0] == p3["free_blocks"][1])
            p4 = await _drain_wave(a, None, drain_prompts, {}, want)
            p4["ok"] = (p4["drain_status"] == 200 and p4["drain"]["parked"] == 8
                        and p4["repeat_status"] == 409 and p4["repeat_phase"] == "parked"
                        and p4["held"] and p4["undrain_status"] == 200 and p4["equal"] == 8
                        and p4["free_blocks"][0] == p4["free_blocks"][1])
            rec["P2"], rec["P3"], rec["P4"] = p2, p3, p4
            rec["launches"] = dict(_build.LAUNCHES)
            bulk_reference[:] = [bulk_prompts, want_bulk]
            return rec
        finally:
            if a is not None:
                await a.close()
            await peer.close()

    asyncio.run(run())
    parts = ("P1", "P2", "P3", "P4")
    rec["ok"] = (all(rec[p]["ok"] for p in parts)
                 and all(rec["launches"].get(k, 0) > 0 for k in KERNELS))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"serve_pack: {[p for p in parts if not rec[p]['ok']]} failed, "
                             f"or a kernel never launched (see the record)")
    return {**rec["launches"], "bulk_reference": bulk_reference}


# -- the telemetry plane ------------------------------------------------------------

OBS_REQUESTS = 32  # O1's distinct prompts
OBS_LENS = (32, 600)  # their lengths: uniform in this range
OBS_PROCESSES = 2  # the load harness's client processes
OBS_CONCURRENCY = 8  # requests in flight a process
OBS_PROFILE_REQUESTS = 8  # O3's profiled wave
OBS_ZOO_REQUESTS = 8  # O4's 16-image ResNet-50 requests
OBS_MODEL = f"llama:{SERVE_PRESET}"  # the generative unit's model label


def _fetch(port: int, path: str, timeout: float = 60.0) -> tuple[int, bytes]:
    """GET ``path`` -> (status, body)."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _prom(text: str) -> dict:
    """The phase's own exposition parser (text 0.0.4 or OpenMetrics):
    ``{(sample, labels): (value, exemplar labels or None)}``."""
    import re

    out = {}
    pat = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)(?: # (\{[^}]*\}) \S+ \S+)?$')
    lab = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = pat.match(line)
        if m is None:
            raise AssertionError(f"/prometheus: unparsable line {line!r}")
        name, labels, value, ex = m.groups()
        key = (name, tuple(sorted(lab.findall(labels or ""))))
        out[key] = (float(value), dict(lab.findall(ex)) if ex else None)
    return out


def _prom_sum(samples: dict, name: str, **labels) -> float:
    return sum(v for (n, lab), (v, _) in samples.items()
               if n == name and all(dict(lab).get(k) == x for k, x in labels.items()))


async def _otlp_collector(received: list):
    """A loopback OTLP/HTTP collector (stdlib): every POSTed body, parsed."""

    async def handle(reader, writer):
        try:
            while line := await reader.readline():
                length = 0
                while (h := await reader.readline()) not in (b"\r\n", b""):
                    name, _, value = h.decode().partition(":")
                    if name.strip().lower() == "content-length":
                        length = int(value)
                received.append(json.loads(await reader.readexactly(length)))
                writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\n{}")
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    return await asyncio.start_server(handle, "127.0.0.1", 0)


class _LoopShare:
    """The event loop's busy share of a window: the selector's blocking
    time is its idle time."""

    def __init__(self, loop):
        self.sel, self.idle = loop._selector, 0.0
        self._select = self.sel.select

        def select(timeout=None):
            t0 = time.perf_counter()
            try:
                return self._select(timeout)
            finally:
                self.idle += time.perf_counter() - t0

        self.sel.select = select
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        self.sel.select = self._select
        window = time.perf_counter() - self.t0
        return max(0.0, 1.0 - self.idle / window) if window > 0 else 0.0


def _trace_kernels(path: str) -> dict:
    """A Chrome trace's device work: ``{"kernels": {name: (count, us)},
    "graph_launches": n, "window_us": w}``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels: dict = {}
    launches, lo, hi = 0, None, None
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "kernel":
            n, us = kernels.get(e["name"], (0, 0.0))
            kernels[e["name"]] = (n + 1, us + float(e.get("dur", 0)))
        if e.get("name") == "cudaGraphLaunch":
            launches += 1
        ts = float(e.get("ts", 0))
        lo = ts if lo is None else min(lo, ts)
        hi = max(hi or 0.0, ts + float(e.get("dur", 0)))
    return {"kernels": kernels, "graph_launches": launches,
            "window_us": (hi - lo) if lo is not None else 0.0}


async def _obs_wave(port: int, payloads, processes: int = OBS_PROCESSES):
    """The load harness's run: each payload once, over ``processes`` spawned
    client processes; returns the result and its tokens by payload."""
    from seldon_core_tpu_torch.testing import loadtest

    res = await asyncio.to_thread(
        loadtest.run_load, f"http://127.0.0.1:{port}/api/v0.1/predictions", payloads,
        processes=processes, concurrency=OBS_CONCURRENCY, once=True, timeout_s=300.0)
    toks = [json.loads(json.loads(r)["strData"])["tokens"] if r is not None else None
            for r in res.replies]
    return res, toks


def _planes(on: bool, saved: dict | None = None) -> dict:
    """Turn every telemetry plane of the process off (``on=False``: the
    timeline, the meter, span recording, the exporters, exemplars), or
    back as ``saved`` had them."""
    from seldon_core_tpu_torch.obs import METER, RECORDER, TIMELINE

    if not on:
        saved = {"timeline": TIMELINE.enabled, "meter": METER.enabled,
                 "sample": RECORDER.sample, "exporters": RECORDER.exporters,
                 "exemplars": os.environ.get("SCT_METRICS_EXEMPLARS")}
        TIMELINE.enabled = METER.enabled = False
        RECORDER.sample, RECORDER.exporters = 0.0, []
        os.environ["SCT_METRICS_EXEMPLARS"] = "0"
        return saved
    TIMELINE.enabled, METER.enabled = saved["timeline"], saved["meter"]
    RECORDER.sample, RECORDER.exporters = saved["sample"], saved["exporters"]
    if saved["exemplars"] is None:
        os.environ.pop("SCT_METRICS_EXEMPLARS", None)
    else:
        os.environ["SCT_METRICS_EXEMPLARS"] = saved["exemplars"]
    return saved


def phase_serve_obs(device: str = "cuda", preset: str = SERVE_PRESET) -> dict:
    """The telemetry plane at llama3-1b width (16 layers, bf16, 8 slots,
    16-step blocks).  O1: engine A with every plane on (the timeline,
    trace-id exemplars, spans exported to a loopback OTLP collector) takes
    32 distinct prompts of 32-600 tokens (32 new tokens, greedy) from the
    load harness's 2 spawned client processes; engine B, every plane off,
    takes the same.  O2: B in the prefill role hands a traced request off
    to A.  O3: ``/profile/start`` and ``/stop`` around a wave on A (again
    on the eager loop when the replayed blocks show no K2).  O4: a
    ResNet-50 unit behind the batching queue.  Returns the phase's launch
    counts."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.obs import LOOP_LAG, RECORDER, TIMELINE, host_sync_snapshot
    from seldon_core_tpu_torch.ops import _build
    from seldon_core_tpu_torch.utils.roofline import chip_peak_flops, count_flops

    rng = np.random.default_rng(13)
    rec: dict = {"phase": "serve_obs", "card": _card(), "preset": preset, "dtype": "bfloat16",
                 "n_slots": SERVE_SLOTS, "decode_block": SERVE_BLOCK}
    gates: dict = {}

    async def run() -> None:
        received: list = []
        collector = await _otlp_collector(received)
        env = {"SCT_OTLP_ENDPOINT":
               f"http://127.0.0.1:{collector.sockets[0].getsockname()[1]}/v1/traces",
               "SCT_METRICS_EXEMPLARS": "1", "SCT_TIMELINE": "1"}
        saved_env = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        a = b = None
        try:
            a, boot_a = await _boot(_serve_spec(preset, 0, name="obs"), device)
            b, boot_b = await _boot(_serve_spec(preset, 0, name="obs-off"), device,
                                    role="prefill", decode_upstreams=[f"127.0.0.1:{a.port}"])
            rec["boot_s"] = [boot_a, boot_b]
            ma = a.service.walker.component.model
            vocab = ma.cfg.vocab_size
            lo, hi = OBS_LENS
            prompts = [rng.integers(0, vocab, int(n)).tolist()
                       for n in rng.integers(lo, hi + 1, OBS_REQUESTS)]
            payloads = [json.dumps({"strData": json.dumps({"tokens": p})}).encode()
                        for p in prompts]
            # ---- O1, planes on (engine A)
            warm = ma.program_snapshot()["program_compiles"]
            syncs0, blocks0 = host_sync_snapshot().get(OBS_MODEL, 0), ma.decode_blocks
            code, raw = await asyncio.to_thread(_fetch, a.port, "/prometheus")
            prom0 = _prom(raw.decode())
            await asyncio.sleep(0.2)  # the scrape's own wire record lands after its reply
            wire = a._wire
            wire0 = (wire.requests, wire.bytes_in, wire.bytes_out)
            LOOP_LAG.max_lag_s = 0.0  # the probe's maximum over this wave alone
            _build.reset_launches()  # the main path's run starts here
            res, toks = await _obs_wave(a.port, payloads)
            loop_lag = LOOP_LAG.snapshot()
            await asyncio.sleep(0.2)
            wire1 = (wire.requests, wire.bytes_in, wire.bytes_out)
            o1 = {"harness": res.summary(), "tokens_per_s": sum(map(len, filter(None, toks)))
                  / res.window_s}
            blocks = ma.decode_blocks - blocks0
            o1["decode_blocks"] = blocks
            o1["host_syncs"] = host_sync_snapshot().get(OBS_MODEL, 0) - syncs0
            o1["captures_after_warmup"] = ma.program_snapshot()["program_compiles"] - warm
            code, raw = await asyncio.to_thread(_fetch, a.port, "/prometheus")
            prom1 = _prom(raw.decode())
            delta = lambda name, **kw: (_prom_sum(prom1, name, **kw)  # noqa: E731
                                        - _prom_sum(prom0, name, **kw))
            received_tokens = sum(len(t) for t in toks if t)
            o1["prom_requests"] = delta("seldon_api_engine_server_requests_duration_seconds_count",
                                        service="predictions", code="200")
            o1["prom_tokens"] = delta("seldon_generative_tokens_total", model_name=OBS_MODEL)
            mfu = [v for (n, lab), (v, _) in prom1.items() if n == "seldon_executor_mfu"
                   and dict(lab).get("model_name") == OBS_MODEL]
            o1["mfu"] = mfu[0] if mfu else None
            exemplars = {ex["trace_id"] for (n, _), (_, ex) in prom1.items()
                         if ex and n == "seldon_generative_ttft_seconds_bucket"}
            o1["wire"] = [x - y for x, y in zip(wire1, wire0)]
            timelines = []
            for tid in res.trace_ids:
                code, raw = await asyncio.to_thread(_fetch, a.port,
                                                    f"/stats/timeline?trace={tid}")
                timelines.append(json.loads(raw)["timeline"] if code == 200 else [])
            o1["timelines_done"] = sum(bool(t) and all(e["done"] for e in t) for t in timelines)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:  # the exporter's drain, within its batches
                exported = {s["traceId"] for r in received
                            for s in r["resourceSpans"][0]["scopeSpans"][0]["spans"]}
                if set(res.trace_ids) <= exported:
                    break
                await asyncio.sleep(0.1)
            o1["traces_exported"] = len(set(res.trace_ids) & exported)
            o1["exporter"] = RECORDER.stats(1)["exporters"]
            o1["stats"] = {p: (await asyncio.to_thread(_fetch, a.port, p))[0]
                           for p in ("/stats/warmup", "/stats/summary", "/stats/wire")}
            o1["loop_lag"] = loop_lag
            # ---- O1, planes off (engine B, the same prompts)
            saved = _planes(False)
            try:
                res_off, toks_off = await _obs_wave(b.port, payloads)
            finally:
                _planes(True, saved)
            o1["off"] = {"harness": res_off.summary(),
                         "tokens_per_s": sum(map(len, filter(None, toks_off))) / res_off.window_s}
            o1["equal_to_planes_off"] = sum(x is not None and x == y
                                            for x, y in zip(toks, toks_off))
            gates.update(
                o1_replies=res.requests == OBS_REQUESTS and res.failures == 0
                and all(t is not None and len(t) == MAX_NEW for t in toks),
                o1_equal_to_planes_off=o1["equal_to_planes_off"] == OBS_REQUESTS,
                o1_one_sync_a_block=blocks > 0 and o1["host_syncs"] == blocks,
                o1_no_capture=o1["captures_after_warmup"] == 0,
                o1_prom_requests=o1["prom_requests"] == OBS_REQUESTS,
                o1_prom_tokens=o1["prom_tokens"] == received_tokens,
                o1_wire=o1["wire"] == [OBS_REQUESTS, res.bytes_sent, res.bytes_received],
                o1_timelines=len(res.trace_ids) == OBS_REQUESTS
                and o1["timelines_done"] == OBS_REQUESTS,
                o1_exported=o1["traces_exported"] == OBS_REQUESTS,
                o1_exemplar=bool(exemplars & set(res.trace_ids)),
                o1_stats=all(c == 200 for c in o1["stats"].values()),
                o1_mfu=o1["mfu"] is not None and 0.0 < o1["mfu"] <= 1.0)
            rec["O1"] = o1
            # ---- O2, a stitched disaggregated request: B prefills, A decodes
            tid = os.urandom(16).hex()
            code, raw = await asyncio.to_thread(
                _call, b.port, "/disagg/generate", {"tokens": prompts[0]},
                {"traceparent": f"00-{tid}-{os.urandom(8).hex()}-01"})
            body = json.loads(raw)
            trace = next((t for t in RECORDER.recent_traces(500) if t["trace_id"] == tid), None)
            spans_ = {s["name"]: s for s in (trace or {}).get("spans", [])}
            legs = TIMELINE.by_trace(tid)
            export, imp = spans_.get("handoff.export"), spans_.get("disagg.import")
            o2 = {"status": code, "mode": body.get("mode"),
                  "spans": sorted(spans_), "legs": [(leg["role"], leg["attrs"].get("kind"),
                                                     leg["done"]) for leg in legs]}
            gates.update(
                o2_disagg=code == 200 and body.get("mode") == "disagg"
                and body.get("tokens") == toks[0],
                o2_spans=export is not None and imp is not None
                and imp["parent_id"] == export["span_id"]
                and export["attrs"].get("engine.role") == "prefill",
                o2_timelines=len(legs) == 2 and legs[0]["attrs"].get("kind") == "prefill"
                and any(e["name"] == "handoff-export" for e in legs[0]["events"])
                and legs[1]["attrs"].get("kind") == "imported" and legs[1]["done"] == "budget")
            rec["O2"] = o2
            # ---- O3, /profile around a wave on A
            o3 = {}
            for leg, eager in (("replayed", False), ("eager", True)):
                if leg == "eager" and o3["replayed"]["k2_kernels"]:
                    break  # CUPTI showed the kernels inside the replays
                ma._eager_on_card = eager
                try:
                    out_dir = tempfile.mkdtemp(prefix=f"sct-profile-{leg}-")
                    start = await asyncio.to_thread(_call, a.port, "/profile/start",
                                                    {"dir": out_dir})
                    share = _LoopShare(asyncio.get_running_loop())
                    await _obs_wave(a.port, payloads[:OBS_PROFILE_REQUESTS], processes=1)
                    loop_share = share.stop()
                    stop = await asyncio.to_thread(_call, a.port, "/profile/stop", {})
                finally:
                    ma._eager_on_card = False
                path = json.loads(stop[1])["trace"]
                k = await asyncio.to_thread(_trace_kernels, path)
                names = list(k["kernels"])
                top = sorted(k["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
                o3[leg] = {
                    "status": [start[0], stop[0]], "trace_mb": os.path.getsize(path) / 2**20,
                    "k1_kernels": [n for n in names if "flash" in n],
                    "k2_kernels": [n for n in names if "paged" in n],
                    "graph_launches": k["graph_launches"],
                    "device_kernels": sum(c for c, _ in k["kernels"].values()),
                    "top10_us": [(n[:80], c, round(us, 1)) for n, (c, us) in top],
                    "event_loop_share": loop_share}
                shutil.rmtree(out_dir)  # tens of MB; the record keeps what it showed
            gates.update(
                o3_status=all(v["status"] == [200, 200] for v in o3.values()),
                o3_k1=bool(o3["replayed"]["k1_kernels"]),
                o3_k2=bool(o3["replayed"]["k2_kernels"]) or bool(
                    o3.get("eager", {}).get("k2_kernels")),
                o3_graph_launches=o3["replayed"]["graph_launches"] > 0)
            rec["O3"] = o3
            rec["launches"] = dict(_build.LAUNCHES)
        finally:
            for app in (b, a):
                if app is not None:
                    await app.close()
            collector.close()
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    async def zoo() -> None:
        """O4: a ResNet-50 unit behind the batching queue."""
        unit = _zoo_unit("res", "resnet", 0, input_dtype=("uint8", "STRING"),
                         buckets=("16,32", "STRING"))
        app, boot_s = await _boot(_graph_spec(unit), device)
        try:
            comp = dict(app.service.walker.iter_components())["res"]
            queue = comp.queue
            name = comp.model.name
            cfg = _zoo_cfg("resnet")
            images = [_zoo_rows("resnet", cfg, 16, rng) for _ in range(OBS_ZOO_REQUESTS)]
            syncs0, steps0 = host_sync_snapshot().get(name, 0), queue.steps
            replies, _, _ = await _graph_wave(app.port, [_raw_body(x) for x in images])
            code, raw = await asyncio.to_thread(_fetch, app.port, "/prometheus")
            prom = _prom(raw.decode())
            mfu = [v for (n, lab), (v, _) in prom.items()
                   if n == "seldon_executor_mfu" and dict(lab).get("model_name") == name]
            rows, device_s = queue.last_step
            x = torch.from_numpy(images[0]).to(comp.model.device)
            step_flops, _ = await asyncio.to_thread(count_flops,
                                                    lambda: comp.model._forward(x))
            peak = chip_peak_flops(comp.model.device)
            want = rows * step_flops / 16 / device_s / peak if peak else None
            o4 = {"boot_s": boot_s, "steps": queue.steps - steps0,
                  "host_syncs": host_sync_snapshot().get(name, 0) - syncs0,
                  "status": sorted({c for c, _ in replies}), "mfu": mfu[0] if mfu else None,
                  "flops_per_row": queue.flops_per_row, "roofline_flops_per_row": step_flops / 16,
                  "last_step": [rows, device_s], "mfu_from_roofline": want}
            gates.update(
                o4_replies=o4["status"] == [200],
                o4_one_sync_a_step=o4["steps"] > 0 and o4["host_syncs"] == o4["steps"],
                o4_mfu=o4["mfu"] is not None and want is not None and 0.0 < o4["mfu"] <= 1.0
                and abs(o4["mfu"] - want) <= 0.01 * want)
            rec["O4"] = o4
        finally:
            await app.close()

    asyncio.run(run())
    launches = rec["launches"]
    asyncio.run(zoo())
    gates["launched"] = all(launches.get(k, 0) > 0 for k in KERNELS)
    rec["gates"], rec["ok"] = gates, all(gates.values())
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"serve_obs: gates {[k for k, v in gates.items() if not v]}")
    return launches


# -- checkpoints, conversion, trained heads and packed draft speculation ------------

CKPT_BURST = 16  # S3's chat clients, mid-way through the bulk wave
# S5: a tiny random HF Llama (head dim 64, GQA 4 over 2), the port's f32
# logits on the card against transformers' on the CPU
HF_TINY = dict(vocab_size=128, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
               rope_theta=10000.0, rms_norm_eps=1e-5, attention_bias=False,
               tie_word_embeddings=False)
HF_TOL = 1e-3  # abs and rel: f32 both sides, different summation orders
HF_TOKENS = [5, 9, 2, 17, 3, 42, 8, 1, 77, 12, 100, 31, 64, 7, 99, 15]


def _bits_equal(a, b) -> bool:
    """Two tensors equal bit for bit (dtype, shape and bytes)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b.to(a.device)))


def _sync_device(device: str) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _tree_leaves(tree) -> list:
    return [v for x in tree.values() for v in (_tree_leaves(x) if isinstance(x, dict) else [x])]


def _wave_counts(model, before: tuple) -> dict:
    blocks = model.decode_blocks - before[0]
    return {"decode_blocks": blocks, "host_syncs": model.host_syncs - before[1],
            "one_sync_a_block": blocks > 0 and model.host_syncs - before[1] == blocks}


def _ckpt_convert(tmp: str, device: str) -> dict:
    """S5: a tiny random HF Llama converted on the CPU, served on the card."""
    try:
        import transformers
    except ImportError as e:
        return {"skipped": f"transformers does not import here: {e}", "ok": True}
    import numpy as np
    import torch

    from seldon_core_tpu_torch.executor.checkpoint import load_params
    from seldon_core_tpu_torch.models.convert import convert_hf_llama
    from seldon_core_tpu_torch.models.weights import params_from_jax

    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(**HF_TINY)).eval()
    hf_dir, out = os.path.join(tmp, "hf"), os.path.join(tmp, "hf.npz")
    hf.save_pretrained(hf_dir)
    t0 = time.perf_counter()
    cfg = convert_hf_llama(hf_dir, out)
    convert_s = time.perf_counter() - t0
    toks = torch.tensor([HF_TOKENS])
    with torch.no_grad():
        want = hf(toks).logits.numpy()
        model = params_from_jax(load_params(out), cfg, device=device)
        got = model(toks.to(device=device, dtype=torch.int32), seq_impl="flash").float().cpu()
    got = got.numpy()
    err = float(np.abs(got - want).max())
    close = bool(np.allclose(got, want, rtol=HF_TOL, atol=HF_TOL))
    return {"transformers": transformers.__version__, "config": HF_TINY, "convert_s": convert_s,
            "max_abs_err": err, "tol": HF_TOL, "argmax_equal": bool(
                (got.argmax(-1) == want.argmax(-1)).all()), "ok": close}


def phase_serve_checkpoint(serve: dict, spec: dict, pack: dict, device: str = "cuda",
                           preset: str = SERVE_PRESET) -> dict:
    """Weights from disk at llama3-1b width (bf16).  S1: ``serve``'s seeded
    weights saved with the port's ``save_params`` and served through the
    ``checkpoint`` graph parameter: ``serve``'s streams, every loaded bf16
    leaf bit-equal to the saved one.  S2: the Medusa heads ``serve_spec``
    synthesizes (``spec_draft=3``) saved and served through
    ``spec_heads_path``: the streams of speculation off, the acceptance
    ledger of ``serve_spec``'s heads run, one sync a block; a malformed
    heads file refused at boot by name.  S3: ``chat`` and ``bulk`` (batch,
    ``spec_method=draft``) packed on the card, a 16-client chat burst while
    bulk decodes: bulk's streams equal its unpacked run (``serve_pack``'s
    sole bulk engine; greedy speculation emits the streams of speculation
    off), every draft prefill deferred and run under ``bulk/draft``'s
    grant, one a bulk admission.  S4: a ResNet-50 unit's
    ``save_checkpoint`` served by a second unit with another seed through
    ``checkpoint``: equal replies.  S5: a tiny random HF Llama converted
    and its logits on the card against transformers' on the CPU, when
    ``transformers`` imports (reported as skipped otherwise).  Returns the
    kernels' launches over S1-S3's waves."""
    import base64

    import numpy as np
    import torch

    from seldon_core_tpu_torch.engine.service import PredictionService, load_co_predictor_specs
    from seldon_core_tpu_torch.executor.arbiter import get_arbiter
    from seldon_core_tpu_torch.executor.checkpoint import load_params, save_params
    from seldon_core_tpu_torch.models import llama
    from seldon_core_tpu_torch.models.registry import resolve_config
    from seldon_core_tpu_torch.models.weights import init_params, params_from_jax, params_to_jax
    from seldon_core_tpu_torch.ops import _build

    cfg = resolve_config(preset)
    prompts, outs = serve["prompts"], serve["outs"]
    launches = {name: 0 for name in KERNELS}
    rec: dict = {"phase": "serve_checkpoint", "card": _card(), "preset": preset,
                 "dtype": "bfloat16"}
    tmp = tempfile.mkdtemp(prefix="sct-ckpt-")

    def count() -> None:
        for name in KERNELS:
            launches[name] += _build.LAUNCHES[name]

    async def wave(app, ps) -> tuple[list, dict]:
        model = app.service.walker.component.model
        before = (model.decode_blocks, model.host_syncs)
        _build.reset_launches()  # a wave of the main path starts here
        replies, wave_s = await _serve_wave(app.port, ps)
        count()
        got = _check_replies(replies, ps, cfg.vocab_size)
        await _quiet(model)
        return got, {"wave_s": wave_s, **_wave_counts(model, before)}

    async def s1_s2() -> tuple[dict, dict]:
        # S1: save serve's seeded weights, load them apart, serve them
        t0 = time.perf_counter()
        seeded = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                             dtype=torch.bfloat16, device=device)
        _sync_device(device)
        make_s = time.perf_counter() - t0
        path = os.path.join(tmp, "llama3-1b.npz")
        t0 = time.perf_counter()
        leaves = save_params(path, params_to_jax(seeded))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree = load_params(path)
        read_s = time.perf_counter() - t0
        host_bf16 = all(isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
                        for x in _tree_leaves(tree))
        t0 = time.perf_counter()
        loaded = params_from_jax(tree, cfg, device=device)
        _sync_device(device)
        upload_s = time.perf_counter() - t0
        want = dict(seeded.named_parameters())
        bit_equal = all(_bits_equal(t, want[k]) for k, t in loaded.named_parameters())
        del tree, loaded
        s1 = {"file_bytes": os.path.getsize(path), "leaves": leaves,
              "param_bytes": sum(p.nbytes for p in seeded.parameters()),
              "save_s": save_s, "load_host_read_s": read_s, "load_upload_s": upload_s,
              "seeded_make_s": make_s, "loaded_leaves_bf16_on_host": host_bf16,
              "loaded_bit_equal": bit_equal}
        app, s1["ready_s"] = await _boot(_serve_spec(preset, 0, name="ckpt",
                                                     checkpoint=(path, "STRING")), device)
        s1["seeded_ready_s"] = serve["boot_and_warmup_s"]
        try:
            got, s1["wave"] = await wave(app, prompts)
        finally:
            await app.close()
        s1["streams_equal"] = _streams_equal(outs, got)
        s1["ok"] = (bit_equal and host_bf16 and s1["streams_equal"] == len(prompts)
                    and s1["wave"]["one_sync_a_block"])
        # S2: the heads serve_spec synthesizes, from a file
        heads = llama.init_medusa_heads(torch.Generator(device=device).manual_seed(0), cfg,
                                        SPEC_DRAFT, base_head=seeded.head,
                                        dtype=torch.bfloat16, device=device)
        hpath = os.path.join(tmp, "medusa.npz")
        t0 = time.perf_counter()
        save_params(hpath, heads)
        s2 = {"file_bytes": os.path.getsize(hpath), "save_s": time.perf_counter() - t0,
              "shapes": {k: list(v.shape) for k, v in heads.items()}}
        del seeded
        ref = spec["ledgers"]["heads"]
        app, s2["ready_s"] = await _boot(_serve_spec(
            preset, 0, name="heads", checkpoint=(path, "STRING"), spec_draft=(SPEC_DRAFT, "INT"),
            spec_method=("heads", "STRING"), spec_heads_path=(hpath, "STRING")), device)
        s2["synthesized_ready_s"] = ref["boot_s"]
        try:
            model = app.service.walker.component.model
            s2["heads_bit_equal"] = all(_bits_equal(model._heads[k], heads[k]) for k in heads)
            s2["spec_heads"] = model.spec_heads
            before = (model.spec_emitted_tokens, model.spec_verify_passes)
            got, s2["wave"] = await wave(app, ref["prompts"])
            s2["ledger"] = [model.spec_emitted_tokens - before[0],
                            model.spec_verify_passes - before[1]]
        finally:
            await app.close()
        s2["synthesized_ledger"] = [ref["emitted"], ref["passes"]]
        s2["streams_equal_spec_off"] = _streams_equal(outs, got)
        bad = os.path.join(tmp, "bad-medusa.npz")
        save_params(bad, {"w1": np.zeros((2, 8, 8), np.float32),
                          "head": np.zeros((2, 8, cfg.vocab_size), np.float32)})
        try:
            app, _ = await _boot(_serve_spec(preset, 0, name="bad", spec_draft=(SPEC_DRAFT, "INT"),
                                             spec_method=("heads", "STRING"),
                                             spec_heads_path=(bad, "STRING")), device)
            await app.close()
            s2["malformed_refused"] = None
        except Exception as e:  # noqa: BLE001 - the refusal is the expected outcome
            s2["malformed_refused"] = str(e)[:300]
        s2["ok"] = (s2["heads_bit_equal"] and s2["spec_heads"] == SPEC_DRAFT
                    and s2["streams_equal_spec_off"] == len(prompts)
                    and s2["ledger"] == s2["synthesized_ledger"]
                    and s2["wave"]["one_sync_a_block"]
                    and "Medusa checkpoint" in (s2["malformed_refused"] or "")
                    and bad in (s2["malformed_refused"] or ""))
        return s1, s2

    async def s3() -> dict:
        rng = np.random.default_rng(14)
        bulk_prompts, want_bulk = pack["bulk_reference"]
        lo, hi = PACK_BURST_LENS
        burst = [rng.integers(0, cfg.vocab_size, n).tolist()
                 for n in rng.integers(lo, hi + 1, CKPT_BURST)]
        chat_spec = _serve_spec(preset, 0, name="chat", pack_slo_ms=(PACK_SLO_MS, "FLOAT"))
        bulk_dict = _serve_spec_dict(
            preset, PACK_BULK_SEED, name="bulk", pack_class=("batch", "STRING"),
            top_k=(PACK_TOP_K, "INT"), spec_draft=(SPEC_DRAFT, "INT"),
            spec_method=("draft", "STRING"), spec_draft_model=("truncate:auto", "STRING"))
        co = [PredictionService(sp, device=device) for sp in load_co_predictor_specs(
            {"ENGINE_CO_PREDICTORS": base64.b64encode(json.dumps([bulk_dict]).encode()).decode()})]
        a, boot_s = await _boot(chat_spec, device, co_services=co)
        try:
            chat, bulk = a.service.walker.component, co[0].walker.component
            cm, bm, cs, bs = chat.model, bulk.model, chat.scheduler, bulk.scheduler
            arb = get_arbiter()
            deps = arb.snapshot()["deployments"]
            rec3 = {"boot_and_warmup_s": boot_s, "registrants": {
                k: d["priority"] for k, d in deps.items()},
                "bulk_keys": [bs._arb_key, bs._arb_draft_key],
                "draft_prefills_after_warmup": bm.draft_prefills}
            runs, dispatched, draining = [], [0], [0]
            drain, run1, dispatch = (bm.drain_draft_prefills, bm._exec_draft_prefill,
                                     bm.draft_prefill_dispatch)

            def logged_drain():
                draining[0] += 1
                try:
                    return drain()
                finally:
                    draining[0] -= 1

            def logged_run(payload):
                runs.append((draining[0] > 0, arb._holder))
                return run1(payload)

            def logged_dispatch(*args, **kw):
                dispatched[0] += 1
                return dispatch(*args, **kw)

            bm.drain_draft_prefills, bm._exec_draft_prefill = logged_drain, logged_run
            bm.draft_prefill_dispatch = logged_dispatch
            base = {m: (m.decode_blocks, m.host_syncs) for m in (cm, bm)}
            d0, i0 = bm.draft_prefills, bm.imports
            _build.reset_launches()  # the packed wave of the main path starts here
            stamps: list = []
            tasks = await _bulk_wave(bs, bulk_prompts, stamps)
            await _until(lambda: len(stamps) >= PACK_MID * len(bulk_prompts), 180.0,
                         "the bulk wave to reach its middle")
            n0 = len(cs.ttft)
            replies, t_b0, t_b1 = await _burst(a.port, burst)
            ttft = _ttfts_since(cs, n0)
            got = [o.tolist() for o in await asyncio.gather(*tasks)]
            t_end = max(stamps)
            admissions = len(bulk_prompts) + bm.imports - i0
            await _until(lambda: bm.draft_prefills - d0 >= admissions, 60.0,
                         "the deferred draft prefills to drain")
            await _quiet(bm)
            count()
            rec3.update({
                "burst_ok": sum(r["status"] == 200 for r in replies),
                "bulk_equal_unpacked": sum(g == w for g, w in zip(got, want_bulk)),
                "admissions": admissions, "imports": bm.imports - i0,
                "draft_dispatches": dispatched[0], "draft_prefills": bm.draft_prefills - d0,
                "draft_runs_from_the_deferral": sum(d for d, _ in runs),
                "draft_run_holders": sorted({h or "" for _, h in runs}),
                "chat_ttft_ms": {"p50": 1e3 * _pct(ttft, 0.5), "p99": 1e3 * _pct(ttft, 0.99)},
                "bulk_tokens_per_s": {"before": _rate(stamps, min(stamps), t_b0),
                                      "during": _rate(stamps, t_b0, t_b1)},
                "burst_s": t_b1 - t_b0, "bulk_s": t_end - min(stamps),
                "spec": {k: bm.spec_snapshot()[k] for k in (
                    "spec_verify_passes", "spec_emitted_tokens", "accepted_tokens_per_step")},
                "arbiter": {k: arb.snapshot()[k] for k in ("grants", "preemptions", "resumes")},
                "packing": {k: bs.packing_snapshot()[k] for k in ("suspends", "resumes")},
                "syncs_per_block": [(m.host_syncs - base[m][1])
                                    / max(1, m.decode_blocks - base[m][0]) for m in (cm, bm)],
            })
        finally:
            await a.close()
        bulk_key, draft_key = rec3["bulk_keys"]
        rec3["ok"] = (draft_key == f"{bulk_key.partition('#')[0]}/draft"
                      and rec3["registrants"].get(draft_key) == "batch"
                      and len(rec3["registrants"]) == 3
                      and rec3["draft_prefills_after_warmup"] == 0
                      and rec3["burst_ok"] == CKPT_BURST
                      and rec3["bulk_equal_unpacked"] == len(bulk_prompts)
                      and rec3["draft_prefills"] == rec3["admissions"] == rec3["draft_dispatches"]
                      and rec3["draft_runs_from_the_deferral"] == len(runs) == rec3["admissions"]
                      and rec3["draft_run_holders"] == [draft_key]
                      and rec3["syncs_per_block"] == [1.0, 1.0])
        return rec3

    async def s4() -> dict:
        images = _zoo_rows("resnet", _zoo_cfg("resnet"), 16, np.random.default_rng(14))
        body = _raw_body(images)
        unit = dict(input_dtype=("uint8", "STRING"), buckets=("16", "STRING"))
        rpath = os.path.join(tmp, "resnet50.npz")
        app, boot_a = await _boot(_graph_spec(_zoo_unit("res", "resnet", 0, **unit)), device)
        try:
            r_a = await asyncio.to_thread(_req, app.port, body)
            t0 = time.perf_counter()
            leaves = dict(app.service.walker.iter_components())["res"].model.save_checkpoint(rpath)
            save_s = time.perf_counter() - t0
        finally:
            await app.close()
        # another seed: the replies can only agree through the checkpoint
        app, boot_b = await _boot(_graph_spec(_zoo_unit(
            "res", "resnet", 7, checkpoint=(rpath, "STRING"), **unit)), device)
        try:
            r_b = await asyncio.to_thread(_req, app.port, body)
        finally:
            await app.close()
        out = [_raw_reply(json.loads(r["raw"])) if r["status"] == 200 else None
               for r in (r_a, r_b)]
        equal = out[0] is not None and out[1] is not None and np.array_equal(out[0], out[1])
        return {"file_bytes": os.path.getsize(rpath), "leaves": leaves, "save_s": save_s,
                "ready_s": [boot_a, boot_b], "status": [r_a["status"], r_b["status"]],
                "rows": 16, "replies_equal": bool(equal), "ok": bool(equal)}

    def part(names, fn, *args):
        """Run one part; a part that raises is recorded as failed, so the
        record still names what passed."""
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception as e:  # noqa: BLE001 - recorded, and the phase fails below
            out = [{"ok": False, "error": f"{type(e).__name__}: {e}"[:600]}] * len(names)
        for name, r in zip(names, out):
            rec[name] = r
        rec["seconds"]["+".join(names)] = time.perf_counter() - t0

    rec["seconds"] = {}
    try:
        part(("S1", "S2"), lambda: asyncio.run(s1_s2()))
        part(("S3",), lambda: [asyncio.run(s3())])
        part(("S4",), lambda: [asyncio.run(s4())])
        part(("S5",), lambda: [_ckpt_convert(tmp, device)])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["launches"] = launches
    parts = ("S1", "S2", "S3", "S4", "S5")
    rec["ok"] = (all(rec[p]["ok"] for p in parts) and all(n > 0 for n in launches.values()))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"serve_checkpoint: {[p for p in parts if not rec[p]['ok']]} "
                             "failed, or a kernel never launched (see the record)")
    return launches


GW_POLL_S = 0.25  # SCT_GW_ROUTE_POLL_S in serve_gateway (the default 2 s would leave it waiting)
GW_FLEET_POLL_S = 0.5  # SCT_FLEET_POLL_S (default 10 s)
GW_CONNS = 16  # SCT_GW_UPSTREAM_CONNS: a wave's requests each on a connection of its own
GW_PAIRS = 3  # W2's measured (direct, gateway) wave pairs
GW_HOP_ROUNDS = 2  # W2's one-at-a-time pairs: serve's prompts, this many times
GW_PREFIX = 512  # W3's shared system prompt: 32 full 16-row blocks
GW_SUFFIXES = (32, 36, 41, 45, 50, 54, 59, 64)  # W3's 8 distinct suffixes
GW_SSE_NEW = 128  # W4's streamed tokens: 8 decode blocks
GW_TAPPED = 8  # W6's tapped predictions
GW_TIMEOUT_S = 60.0  # a W5 client's timeout
GW_READY_S = 90.0  # the gateway process's time to /ready


def _traceparent() -> str:
    return f"00-{os.urandom(16).hex()}-{os.urandom(8).hex()}-01"


def _http(port: int, method: str, path: str, body: bytes | None = None,
          headers: dict | None = None, timeout: float = 600.0) -> dict:
    """One request over a raw socket (no hop-by-hop header: a splice
    forwards the bytes as sent) -> its status, headers, body, the bytes sent
    and received, and the wall seconds."""
    import socket

    head = f"{method} {path} HTTP/1.1\r\nhost: 127.0.0.1:{port}\r\n"
    for k, v in (headers or {}).items():
        head += f"{k}: {v}\r\n"
    if body is not None:
        head += f"content-length: {len(body)}\r\n"
    req = head.encode() + b"\r\n" + (body or b"")
    t0 = time.perf_counter()
    sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    data = b""
    try:
        sock.sendall(req)
        while b"\r\n\r\n" not in data:
            chunk = sock.recv(1 << 16)
            if not chunk:
                raise ConnectionError(f"{path}: closed before a response head")
            data += chunk
        hd, _, rest = data.partition(b"\r\n\r\n")
        lines = hd.decode("latin-1").split("\r\n")
        hdrs = {k.lower(): v for k, _, v in (ln.partition(": ") for ln in lines[1:])}
        n = int(hdrs.get("content-length", "-1"))
        while n < 0 or len(rest) < n:
            chunk = sock.recv(1 << 16)
            if not chunk:
                break
            rest += chunk
    finally:
        sock.close()
    return {"status": int(lines[0].split(" ")[1]), "headers": hdrs, "body": rest,
            "sent": len(req), "received": len(hd) + 4 + len(rest),
            "s": time.perf_counter() - t0}


def _raw_exchange(port: int, payload: bytes) -> bytes:
    """Send raw bytes, return the first response's bytes (the framing gates)."""
    import socket

    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        sock.sendall(payload)
        return sock.recv(1 << 16)
    finally:
        sock.close()


class _GatewayProc:
    """The port's gateway as its own process, through its entry point
    (``python -m seldon_core_tpu_torch.gateway.app``) on free loopback
    ports (REST and gRPC); killed on exit."""

    def __init__(self, logdir: str, name: str, deployments: str, env: dict):
        self.port = _free_port()
        self.grpc_port = _free_port()  # its gRPC relay's (the default 5000 is one for all)
        self.logpath = os.path.join(logdir, f"{name}.log")
        self.log = open(self.logpath, "ab")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "seldon_core_tpu_torch.gateway.app", "--host", "127.0.0.1",
             "--port", str(self.port), "--grpc-port", str(self.grpc_port),
             "--deployments", deployments],
            cwd=ROOT, stdout=self.log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": ROOT, **env})

    def wait_ready(self) -> float:
        t0 = time.perf_counter()
        while True:
            if self.proc.poll() is not None:
                raise AssertionError(f"the gateway exited with {self.proc.returncode}: "
                                     f"{self.tail()}")
            try:
                if _get(self.port, "/ready") == 200:
                    return time.perf_counter() - t0
            except (urllib.error.URLError, OSError):
                pass  # not listening yet
            if time.perf_counter() - t0 > GW_READY_S:
                raise AssertionError(f"the gateway was not ready in {GW_READY_S} s")
            time.sleep(0.1)

    def cpu_s(self) -> float:
        """The process's user + system CPU seconds (``/proc/<pid>/stat``)."""
        with open(f"/proc/{self.proc.pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")

    def tail(self) -> str:
        with open(self.logpath, "rb") as f:
            return f.read()[-2000:].decode(errors="replace")

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.log.close()


def _json_get(port: int, path: str) -> dict:
    status, raw = _fetch(port, path, timeout=30)
    if status != 200:
        raise AssertionError(f"GET {path} -> {status}: {raw[:300]!r}")
    return json.loads(raw)


def phase_serve_gateway(serve: dict, device: str = "cuda", preset: str = SERVE_PRESET,
                        seed: int = 0) -> dict:
    """The gateway in front of two llama3-1b engines (``serve``'s graph with
    ``kv_prefix_reuse``), replicas A and B of one deployment, the port's
    gateway spawned through its entry point; a second record, ``chat-a``,
    lists A alone.  W1: tokens, 401s and the splice's framing refusals.
    W2: ``serve``'s prompts through the gateway as a concurrent wave over
    both replicas, and as waves through ``chat-a``, equal the same waves
    sent straight to A (and ``serve``'s streams), one sync a block, the
    ``gateway-h1`` wire edge counting the clients' bytes; it prints the
    hop's added ms on one engine (``chat-a`` against direct, by wave and
    one 1-token request at a time) and the gateway's CPU seconds a request
    less an idle span's of the same length.  W3: a 512-token prefix warmed by one request,
    then 8 requests sharing it all go to that replica, which reuses the
    prefix for each while the other prefills none, with the streams of the
    same prompts prefilled cold on the other replica; then a p2c pick.
    W4: an SSE stream through the splice equals a direct one, its first
    event before its last block.  W6 (fleet, feedback): ``/stats/fleet``
    lists both replicas and sums their own counts; ``/feedback`` moves the
    gateway's reward counter.  W5: B closed, every request answers 200
    from A, B's digest cleared and its breaker open; B rebooted on its port
    is picked again.  W6 (tap): a second gateway with
    ``GATEWAY_TAP_BROKER`` on the port's taplog broker gives one record a
    request, keyed by its puid.  Returns the kernels' launches on the
    gateway's path: the reboot's warmup and every reference request sent
    straight to an engine are taken off."""
    import numpy as np

    from seldon_core_tpu_torch.ops import _build
    from seldon_core_tpu_torch.taplog import TapBrokerClient, TapBrokerServer

    spec = _serve_spec(preset, seed, kv_prefix_reuse=("true", "BOOL"))
    rng = np.random.default_rng(seed + 15)
    prompts = serve["prompts"]
    gw_env = {"SCT_GW_ROUTE_POLL_S": str(GW_POLL_S), "SCT_FLEET_POLL_S": str(GW_FLEET_POLL_S),
              "SCT_GW_UPSTREAM_CONNS": str(GW_CONNS)}
    rec: dict = {"phase": "serve_gateway", "card": _card(), "preset": preset,
                 "dtype": "bfloat16", "kv_prefix_reuse": True, "gateway_env": gw_env}
    launches = {name: 0 for name in KERNELS}
    # launches of reference traffic sent straight to an engine, not the
    # gateway's path: taken off the phase's count
    reference_launches = {name: 0 for name in KERNELS}
    tmp = tempfile.mkdtemp(prefix="sct-gw-")

    def body_of(p, max_new=MAX_NEW) -> bytes:
        return json.dumps({"strData": json.dumps({"tokens": list(p),
                                                  "max_new_tokens": max_new})}).encode()

    def tokens_of(r: dict) -> list[int] | None:
        if r["status"] != 200:
            return None
        return json.loads(json.loads(r["body"])["strData"])["tokens"]

    async def wave(port: int, bodies, headers: dict) -> list[dict]:
        loop = asyncio.get_running_loop()
        with concurrent.futures.ThreadPoolExecutor(len(bodies)) as clients:
            return list(await asyncio.gather(*(loop.run_in_executor(
                clients, lambda b=b: _http(port, "POST", "/api/v0.1/predictions", b,
                                           {**headers, "traceparent": _traceparent()}))
                for b in bodies)))

    async def reference(aw):
        before = dict(_build.LAUNCHES)
        try:
            return await aw
        finally:
            for name in KERNELS:
                reference_launches[name] += _build.LAUNCHES[name] - before[name]

    def model_of(app):
        return app.service.walker.component.model

    async def run() -> None:
        t_phase = time.perf_counter()
        a, a_boot = await _boot(spec, device)
        b, b_boot = await _boot(spec, device)
        rec["ready_s"] = {"A": a_boot, "B": b_boot}
        b_port = b.port
        keys = {"A": f"127.0.0.1:{a.port}", "B": f"127.0.0.1:{b_port}"}
        deps = os.path.join(tmp, "deployments.json")
        with open(deps, "w") as f:
            json.dump([{"name": "chat", "oauth_key": "chat-key", "oauth_secret": "chat-secret",
                        "engine_host": "127.0.0.1", "engine_rest_port": a.port,
                        "endpoints": [keys["A"], keys["B"]]},
                       # A alone: W2's hop without a split over two engines
                       {"name": "chat-a", "oauth_key": "chat-a-key",
                        "oauth_secret": "chat-a-secret", "engine_host": "127.0.0.1",
                        "engine_rest_port": a.port}], f)
        procs, broker, b2 = [], None, None
        syncs = {}
        try:
            gw = _GatewayProc(tmp, "gateway", deps, gw_env)
            procs.append(gw)
            rec["gateway_ready_s"] = await asyncio.to_thread(gw.wait_ready)
            gp = gw.port
            models = {"A": model_of(a), "B": model_of(b)}
            base = {k: (m.decode_blocks, m.host_syncs) for k, m in models.items()}
            _build.reset_launches()  # the main path's run starts here

            # -- W1: auth and framing
            form = b"grant_type=client_credentials&client_id=chat-key&client_secret="
            ctype = {"content-type": "application/x-www-form-urlencoded"}
            good = await asyncio.to_thread(_http, gp, "POST", "/oauth/token",
                                           form + b"chat-secret", ctype)
            bad = await asyncio.to_thread(_http, gp, "POST", "/oauth/token", form + b"nope",
                                          ctype)
            token = json.loads(good["body"]).get("access_token", "")
            auth = {"authorization": f"Bearer {token}", "content-type": "application/json"}
            anon = await asyncio.to_thread(_http, gp, "POST", "/api/v0.1/predictions",
                                           body_of(VERIFY_PROMPT),
                                           {"content-type": "application/json"})
            framing = {}
            for name, raw in (
                ("conflicting_content_length", b"POST /api/v0.1/predictions HTTP/1.1\r\n"
                 b"host: x\r\ncontent-length: 3\r\ncontent-length: 5\r\n\r\nabc"),
                ("chunked_upload", b"POST /api/v0.1/predictions HTTP/1.1\r\nhost: x\r\n"
                 b"transfer-encoding: chunked\r\n\r\n"),
                ("space_before_colon", b"POST /api/v0.1/predictions HTTP/1.1\r\n"
                 b"Content-Length : 2\r\n\r\n{}"),
                ("unknown_route", b"GET /nope HTTP/1.1\r\nhost: x\r\n\r\n"),
            ):
                resp = await asyncio.to_thread(_raw_exchange, gp, raw)
                framing[name] = int(resp.split(b" ", 2)[1])
            w1 = {"token": good["status"], "expires_in": json.loads(good["body"]).get(
                      "expires_in"), "wrong_secret": bad["status"], "no_token": anon["status"],
                  **framing}
            # the JAX splice front's statuses: a chunked upload is 411
            w1["ok"] = (w1["token"] == 200 and bool(token) and w1["wrong_secret"] == 401
                        and w1["no_token"] == 401 and framing == {
                            "conflicting_content_length": 400, "chunked_upload": 411,
                            "space_before_colon": 400, "unknown_route": 404})
            rec["W1"] = w1
            if not w1["ok"]:
                raise AssertionError(f"serve_gateway W1: {w1}")

            # -- W2: the splice wave
            bodies = [body_of(p) for p in prompts]
            plain = {"content-type": "application/json"}
            # A's index holds the prompts
            warmup = await reference(wave(a.port, bodies, plain))
            want = [tokens_of(r) for r in warmup]
            scheds = {"A": a.service.walker.component.scheduler,
                      "B": b.service.walker.component.scheduler}
            tok_a = json.loads((await asyncio.to_thread(
                _http, gp, "POST", "/oauth/token",
                b"grant_type=client_credentials&client_id=chat-a-key&client_secret="
                b"chat-a-secret", ctype))["body"])["access_token"]
            auth_a = {**auth, "authorization": f"Bearer {tok_a}"}

            async def engine_side(port, bs, hdrs) -> tuple[list, dict]:
                """A wave and, from the engines, its TTFT p50 and each
                replica's prefills."""
                n0 = {k: (len(scheds[k].ttft), models[k].prefills) for k in scheds}
                out = await wave(port, bs, hdrs)
                ttft = [t for k in scheds for _, t in list(scheds[k].ttft)[n0[k][0]:]]
                return out, {"engine_ttft_ms_p50": 1e3 * _pct(ttft, 0.5) if ttft else None,
                             "prefills": {k: models[k].prefills - n0[k][1] for k in scheds}}

            async def gateway_wave(bs, hdrs, dep: str):
                """A wave through the gateway: its replies, the engines'
                side, whether ``dep``'s ``gateway-h1`` edge counted exactly
                the clients' bytes, and the gateway's CPU and wall seconds
                over the wave alone."""
                w0 = (await asyncio.to_thread(_json_get, gp, "/stats/wire"))["wire"]["stages"]
                cpu, t0 = gw.cpu_s(), time.perf_counter()
                out, eng = await engine_side(gp, bs, hdrs)
                cpu, wall = gw.cpu_s() - cpu, time.perf_counter() - t0
                w1s = (await asyncio.to_thread(_json_get, gp, "/stats/wire"))["wire"]["stages"]
                h0 = w0.get("gateway-h1", {}).get(dep, {"bytes_in": 0, "bytes_out": 0})
                h1 = w1s["gateway-h1"][dep]
                sent, got = sum(r["sent"] for r in out), sum(r["received"] for r in out)
                ok = (h1["bytes_in"] - h0["bytes_in"] == sent
                      and h1["bytes_out"] - h0["bytes_out"] == got)
                return out, {**eng, "bytes_sent": sent, "bytes_received": got}, ok, cpu, wall

            # the wave split over both replicas (p2c and prefixes): its streams
            split, split_eng, wire_ok, _, _ = await gateway_wave(bodies, auth, "chat")
            equal = [tokens_of(r) for r in split] == want
            # the hop: the same wave on A direct and through chat-a (A alone)
            pairs, busy_cpu, busy_s = [], 0.0, 0.0
            for _ in range(GW_PAIRS):
                direct, d_eng = await reference(engine_side(a.port, bodies, plain))
                via, g_eng, ok, cpu, wall = await gateway_wave(bodies, auth_a, "chat-a")
                wire_ok &= ok
                busy_cpu, busy_s = busy_cpu + cpu, busy_s + wall
                equal &= ([tokens_of(r) for r in direct] == want
                          and [tokens_of(r) for r in via] == want)
                added = sorted(1e3 * (g["s"] - d["s"]) for g, d in zip(via, direct))
                pairs.append({"added_ms_p50": added[len(added) // 2],
                              "added_ms_p99": _pct(added, 0.99),
                              "direct_ms_p50": 1e3 * _pct([d["s"] for d in direct], 0.5),
                              "gateway_ms_p50": 1e3 * _pct([g["s"] for g in via], 0.5),
                              "direct_engine": d_eng, "gateway_engine": g_eng})
            # an idle span as long as the gateway's waves: the poller's and
            # the collector's scrapes alone, taken off the waves' CPU
            idle_cpu = gw.cpu_s()
            await asyncio.sleep(busy_s)
            idle_cpu = gw.cpu_s() - idle_cpu
            cpu_per_req = (busy_cpu - idle_cpu) / (GW_PAIRS * len(bodies))
            # one 1-token request at a time on A, direct and through chat-a
            # in alternating order: the hop without a wave's batching
            seq, seq_direct = [], []
            for i in range(GW_HOP_ROUNDS * len(prompts)):
                one = body_of(prompts[i % len(prompts)], 1)
                if i % 2:
                    (g,) = await wave(gp, [one], auth_a)
                    (d,) = await reference(wave(a.port, [one], plain))
                else:
                    (d,) = await reference(wave(a.port, [one], plain))
                    (g,) = await wave(gp, [one], auth_a)
                equal &= d["status"] == g["status"] == 200 and tokens_of(d) == tokens_of(g)
                seq.append(1e3 * (g["s"] - d["s"]))
                seq_direct.append(1e3 * d["s"])
            serve_equal = None if serve.get("outs") is None else want == serve["outs"]
            w2 = {"requests": len(bodies), "split_engine": split_eng, "pairs": pairs,
                  "added_ms_p50": statistics.median(p["added_ms_p50"] for p in pairs),
                  "added_ms_p99": statistics.median(p["added_ms_p99"] for p in pairs),
                  "added_ms_one_at_a_time_p50": _pct(seq, 0.5),
                  "added_ms_one_at_a_time": sorted(seq),
                  "direct_ms_one_at_a_time_p50": _pct(seq_direct, 0.5),
                  "gateway_cpu_s_waves": busy_cpu, "gateway_cpu_s_idle_span": idle_cpu,
                  "gateway_waves_s": busy_s,
                  "gateway_cpu_s_per_request": cpu_per_req, "streams_equal_direct": equal,
                  "streams_equal_serve": serve_equal, "wire_bytes_equal": wire_ok}
            w2["ok"] = equal and wire_ok and serve_equal in (None, True)
            rec["W2"] = w2
            if not w2["ok"]:
                raise AssertionError(f"serve_gateway W2: {w2}")

            # -- W3: prefix-aware routing
            vocab = models["A"].cfg.vocab_size
            prefix = rng.integers(0, vocab, GW_PREFIX).tolist()
            warm_p = prefix + rng.integers(0, vocab, 24).tolist()
            shared = [prefix + rng.integers(0, vocab, n).tolist() for n in GW_SUFFIXES]
            before = {k: m.prefills for k, m in models.items()}
            (warm_r,) = await wave(gp, [body_of(warm_p)], auth)
            warm = next(k for k, m in models.items() if m.prefills > before[k])
            cold = "B" if warm == "A" else "A"
            await asyncio.sleep(2 * GW_POLL_S + 0.1)  # a whole poll after the warm reply
            r0 = (await asyncio.to_thread(_json_get, gp, "/stats/route"))["route"]
            snap = {k: (m.prefills, m.prefills_reused, m.prefix_snapshot()["tokens_reused"],
                        len(scheds[k].ttft)) for k, m in models.items()}
            k1 = _build.LAUNCHES["flash_attention"]
            routed = await wave(gp, [body_of(p) for p in shared], auth)
            k1_routed = _build.LAUNCHES["flash_attention"] - k1
            r1 = (await asyncio.to_thread(_json_get, gp, "/stats/route"))["route"]
            after = {k: (m.prefills, m.prefills_reused, m.prefix_snapshot()["tokens_reused"])
                     for k, m in models.items()}
            ttft_routed = [t for _, t in list(scheds[warm].ttft)[snap[warm][3]:]]
            c0 = (models[cold].prefills, models[cold].prefills_reused, len(scheds[cold].ttft))
            cold_port = a.port if cold == "A" else b_port
            cold_r = await reference(wave(cold_port, [body_of(p) for p in shared], plain))
            ttft_cold = [t for _, t in list(scheds[cold].ttft)[c0[2]:]]
            p2c_p = rng.integers(0, vocab, 40).tolist()
            (p2c_r,) = await wave(gp, [body_of(p2c_p)], auth)
            r2 = (await asyncio.to_thread(_json_get, gp, "/stats/route"))["route"]

            def picks(ra, rb):
                da, db = ra["deployments"].get("chat-key", {}), rb["deployments"]["chat-key"]
                return {n: db[keys[n]]["picked"] - da.get(keys[n], {}).get("picked", 0)
                        for n in ("A", "B")}

            w3 = {"warm": warm, "digest_entries": {n: r0["deployments"]["chat-key"][keys[n]][
                      "digest_entries"] for n in ("A", "B")},
                  "routed_picks": picks(r0, r1),
                  "prefix_picks": r1["prefix_picks"] - r0["prefix_picks"],
                  "warm_reuses": after[warm][1] - snap[warm][1],
                  "warm_tokens_reused": after[warm][2] - snap[warm][2],
                  "cold_prefills_during_routed": after[cold][0] - snap[cold][0],
                  "cold_reference_reuses": models[cold].prefills_reused - c0[1],
                  "k1_launches_routed": k1_routed,
                  "streams_equal_cold": [tokens_of(r) for r in routed]
                  == [tokens_of(r) for r in cold_r],
                  "ttft_ms_routed_p50": 1e3 * _pct(ttft_routed, 0.5) if ttft_routed else None,
                  "ttft_ms_cold_p50": 1e3 * _pct(ttft_cold, 0.5) if ttft_cold else None,
                  "p2c_pick": [n for n, d in picks(r1, r2).items() if d],
                  "p2c_picks": r2["p2c_picks"] - r1["p2c_picks"],
                  "statuses": [warm_r["status"], *(r["status"] for r in routed),
                               *(r["status"] for r in cold_r), p2c_r["status"]]}
            n = len(shared)
            w3["pick_sequence"] = [warm] + [warm if w3["routed_picks"][warm] == n else "?"] * n \
                + w3["p2c_pick"]
            w3["ok"] = (all(s == 200 for s in w3["statuses"]) and w3["digest_entries"][warm] > 0
                        and w3["routed_picks"] == {warm: n, cold: 0} and w3["prefix_picks"] == n
                        and w3["warm_reuses"] == n and w3["warm_tokens_reused"] == n * GW_PREFIX
                        and w3["cold_prefills_during_routed"] == 0
                        and w3["cold_reference_reuses"] == 0 and k1_routed > 0
                        and w3["streams_equal_cold"] and w3["p2c_picks"] == 1
                        and len(w3["p2c_pick"]) == 1)
            rec["W3"] = w3
            if not w3["ok"]:
                raise AssertionError(f"serve_gateway W3: {w3}")

            # -- W4: SSE through the splice
            sse_body = {"tokens": VERIFY_PROMPT, "max_new_tokens": GW_SSE_NEW}
            direct_sse = await reference(asyncio.to_thread(_sse, a.port, sse_body))
            blocks0 = sum(m.decode_blocks for m in models.values())
            via_sse = await asyncio.to_thread(
                _sse, gp, sse_body, None,
                f"authorization: Bearer {token}\r\ntraceparent: {_traceparent()}\r\n",
                lambda: sum(m.decode_blocks for m in models.values()))
            blocks = sum(m.decode_blocks for m in models.values()) - blocks0
            w4 = {"status": via_sse["status"], "content_type": via_sse["content_type"],
                  "events": len(via_sse["events"]),
                  "events_equal_direct": via_sse["events"] == direct_sse["events"],
                  "blocks_before_first_event": via_sse["first"] - blocks0,
                  "blocks": blocks,
                  "first_to_last_event_ms": 1e3 * (via_sse["times"][-1] - via_sse["times"][0])
                  if via_sse["times"] else None}
            w4["ok"] = (w4["status"] == 200 and w4["content_type"] == "text/event-stream"
                        and w4["events_equal_direct"] and w4["events"] == GW_SSE_NEW + 1
                        and blocks >= -(-(GW_SSE_NEW - 1) // SERVE_BLOCK)
                        and w4["blocks_before_first_event"] < blocks)
            rec["W4"] = w4
            if not w4["ok"]:
                raise AssertionError(f"serve_gateway W4: {w4}")

            # -- W6, fleet and feedback (both replicas up)
            deadline = time.perf_counter() + 10 * GW_FLEET_POLL_S + 5
            while True:
                fleet = (await asyncio.to_thread(_json_get, gp, "/stats/fleet"))["fleet"]
                dep = fleet["deployments"].get("chat", {})
                own = [(await asyncio.to_thread(_json_get, port, "/stats/summary"))["qos"][
                    "admitted_total"] for port in (a.port, b_port)]
                total = (dep.get("qos") or {}).get("admitted_total")
                if total == sum(own) or time.perf_counter() > deadline:
                    break
                await asyncio.sleep(GW_FLEET_POLL_S / 2)
            prom0 = _prom((await asyncio.to_thread(_fetch, gp, "/prometheus"))[1].decode())
            fb = await asyncio.to_thread(_http, gp, "POST", "/api/v0.1/feedback",
                                         json.dumps({"reward": 1.0}).encode(), auth)
            prom1 = _prom((await asyncio.to_thread(_fetch, gp, "/prometheus"))[1].decode())
            reward = [_prom_sum(p, "seldon_api_model_feedback_reward_total",
                                deployment_name="chat", model_name="gateway")
                      for p in (prom0, prom1)]
            w6 = {"fleet_replicas": sorted(r["replica"] for r in dep.get("replicas", [])),
                  "fleet_live": dep.get("replicas_live"), "fleet_admitted": total,
                  "engines_admitted": own, "fleet_polls": fleet["collector"]["polls"],
                  "feedback_status": fb["status"], "reward_moved": reward[1] - reward[0]}
            w6["ok"] = (w6["fleet_replicas"] == sorted(keys.values()) and w6["fleet_live"] == 2
                        and total == sum(own) and fb["status"] == 200
                        and w6["reward_moved"] == 1.0)
            rec["W6"] = w6
            if not w6["ok"]:
                raise AssertionError(f"serve_gateway W6 (fleet, feedback): {w6}")

            # -- W5: a replica lost.  B holds a prefix of its own; once B is
            # closed, a wave sharing it is routed to B by B's last digest
            # (until SCT_GW_POLL_FAILS polls fail): each refused connect
            # moves to A and counts on B's breaker
            b_prefix = rng.integers(0, vocab, GW_PREFIX).tolist()
            (b_warm,) = await reference(wave(b_port, [body_of(b_prefix + rng.integers(
                0, vocab, 24).tolist())], plain))
            await asyncio.sleep(2 * GW_POLL_S + 0.1)  # a poll sees B's new digest
            route0 = (await asyncio.to_thread(_json_get, gp, "/stats/route"))["route"]
            syncs["B"] = (models["B"].decode_blocks - base["B"][0],
                          models["B"].host_syncs - base["B"][1])
            a_admitted = a.qos.snapshot()["admitted_total"]
            rerouted0 = (await asyncio.to_thread(_json_get, gp, "/stats/wire"))[
                "h1_frontend"]["rerouted"]
            await b.close()
            b = None
            t_lost = time.perf_counter()
            lost = await wave(gp, [body_of(b_prefix + rng.integers(0, vocab, n).tolist())
                                   for n in GW_SUFFIXES], {**auth})
            lost_s = time.perf_counter() - t_lost
            await asyncio.sleep(2 * GW_POLL_S + 0.1)  # the poller's misses
            route = (await asyncio.to_thread(_json_get, gp, "/stats/route"))["route"]
            st = route["deployments"]["chat-key"][keys["B"]]
            wire = (await asyncio.to_thread(_json_get, gp, "/stats/wire"))["h1_frontend"]
            served_a = a.qos.snapshot()["admitted_total"] - a_admitted
            L1 = dict(_build.LAUNCHES)
            b2, b2_boot = await _boot(spec, device, port=b_port)
            rec["ready_s"]["B_rebooted"] = b2_boot
            models["B2"] = model_of(b2)
            base["B2"] = (models["B2"].decode_blocks, models["B2"].host_syncs)
            _build.reset_launches()
            # after a poll sees B back and its ejection window ends, a pick
            # elects B as the breaker's half-open probe
            back, deadline = [], time.perf_counter() + 30.0
            while b2.qos.snapshot()["admitted_total"] == 0 and time.perf_counter() < deadline:
                await asyncio.sleep(GW_POLL_S)
                p = rng.integers(0, vocab, 24).tolist()
                (r,) = await wave(gp, [body_of(p)], auth)
                back.append(r)
            route2 = (await asyncio.to_thread(_json_get, gp, "/stats/route"))["route"]
            st2 = route2["deployments"]["chat-key"][keys["B"]]
            w5 = {"B_digest_before": route0["deployments"]["chat-key"][keys["B"]][
                      "digest_entries"], "B_warm_status": b_warm["status"],
                  "requests_while_lost": len(lost), "statuses": sorted({r["status"] for r in lost}),
                  "prefix_picks": route["prefix_picks"] - route0["prefix_picks"],
                  "served_by_A": served_a, "rerouted": wire["rerouted"] - rerouted0,
                  "max_wall_s": max(r["s"] for r in lost), "timeout_s": GW_TIMEOUT_S,
                  "wave_s": lost_s, "B_digest_entries": st["digest_entries"],
                  "B_breaker": st["breaker"], "poll_fails": route["poller"]["poll_fails"],
                  "digest_clears": route["poller"]["digest_clears"],
                  "requests_until_B_picked": len(back),
                  "B_served_after_reboot": b2.qos.snapshot()["admitted_total"],
                  "B_breaker_after": st2["breaker"],
                  "statuses_after": sorted({r["status"] for r in back})}
            w5["ok"] = (w5["B_digest_before"] > 0 and w5["statuses"] == [200]
                        and served_a == len(lost)
                        # every pick of B (by its stale digest) moved to A,
                        # until the breaker ejected B
                        and w5["rerouted"] == w5["prefix_picks"] >= route["cb_fails"]
                        and w5["max_wall_s"] < GW_TIMEOUT_S
                        and st["digest_entries"] == 0 and st["breaker"]["open"]
                        and w5["B_served_after_reboot"] >= 1 and not st2["breaker"]["open"]
                        and w5["statuses_after"] == [200])
            rec["W5"] = w5
            if not w5["ok"]:
                raise AssertionError(f"serve_gateway W5: {w5}")

            # -- W6, the tap: a second gateway on the port's taplog broker
            broker = TapBrokerServer(os.path.join(tmp, "tap"), host="127.0.0.1", port=0)
            await broker.start()
            tgw = _GatewayProc(tmp, "gateway-tap", deps, {
                **gw_env, "GATEWAY_TAP_BROKER": f"127.0.0.1:{broker.bound_port}"})
            procs.append(tgw)
            await asyncio.to_thread(tgw.wait_ready)
            tok2 = json.loads((await asyncio.to_thread(
                _http, tgw.port, "POST", "/oauth/token", form + b"chat-secret", ctype))["body"])
            tapped = await wave(tgw.port, [body_of(p) for p in prompts[:GW_TAPPED]],
                                {"authorization": f"Bearer {tok2['access_token']}",
                                 "content-type": "application/json"})
            puids = [json.loads(r["body"])["meta"]["puid"] for r in tapped]
            reader = TapBrokerClient("127.0.0.1", broker.bound_port, timeout_s=5.0)
            records, deadline = [], time.perf_counter() + 10
            while len(records) < len(puids) and time.perf_counter() < deadline:
                records = await reader.fetch("chat-key", 0, 1000)
                await asyncio.sleep(0.1)
            await reader.close()
            w6t = {"tapped": len(tapped), "records": len(records),
                   "keys_equal_puids": sorted(r["key"] for r in records) == sorted(puids),
                   "distinct_puids": len(set(puids))}
            w6t["ok"] = (all(r["status"] == 200 for r in tapped) and w6t["keys_equal_puids"]
                         and w6t["distinct_puids"] == len(tapped)
                         == min(GW_TAPPED, len(prompts)))
            rec["W6_tap"] = w6t
            if not w6t["ok"]:
                raise AssertionError(f"serve_gateway W6 (tap): {w6t}")

            L2 = dict(_build.LAUNCHES)
            for name in KERNELS:
                launches[name] = (L1.get(name, 0) + L2.get(name, 0)
                                  - reference_launches[name])
            for k in ("A", "B2"):
                syncs[k] = (models[k].decode_blocks - base[k][0],
                            models[k].host_syncs - base[k][1])
            rec["decode_blocks_and_syncs"] = syncs
            rec["launches"] = launches
            rec["reference_launches"] = reference_launches
            rec["seconds"] = time.perf_counter() - t_phase
            rec["ok"] = (all(bl > 0 and sy == bl for bl, sy in syncs.values())
                         and all(n > 0 for n in launches.values()))
            if not rec["ok"]:
                raise AssertionError("serve_gateway: a host sync off one a block, or a kernel "
                                     f"never launched: {syncs}, {launches}")
        except BaseException:
            rec.setdefault("ok", False)
            rec["gateway_log"] = procs[0].tail()[-800:] if procs else None
            raise
        finally:
            emit(rec)
            for proc in procs:
                proc.stop()
            if broker is not None:
                await broker.close()
            for app in (a, b, b2):
                if app is not None:
                    await app.close()

    try:
        asyncio.run(run())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# -- serve_grpc: the gRPC plane ---------------------------------------------------

GRPC_DROP_NEW = 1500  # G2's dropped stream asks for this many tokens
GRPC_DROP_AFTER = 2  # ... and its client leaves after this many messages
GRPC_IRIS_REQUESTS = 16
GRPC_PIPE_REQUESTS = 8
GRPC_ZOO_REQUESTS = 8  # 16-image uint8 rawTensor requests, one wave per front
GRPC_ZOO_IMAGES = 16
GRPC_WORKERS = 2
GRPC_WORKER_CONNS = 24  # G4's fresh connections per front
GRPC_DEPLOYMENT = "smoke-dep"  # G4's SELDON_DEPLOYMENT_ID
GRPC_PREDICT = "/seldon.protos.Seldon/Predict"
GRPC_STREAM = "/seldon.protos.Seldon/StreamPredict"
# the JAX engine's StreamPredict refusals: (request strData, status, text)
GRPC_REFUSALS = [
    (None, 3, "StreamPredict takes strData JSON"),
    ({"tokens": [[5, 9], [2]]}, 3,
     "bad stream request: streaming takes ONE prompt: flat 'tokens' list"),
    ({"tokens": [5, 9, 2], "max_new_tokens": "many"}, 3,
     "bad stream request: invalid literal for int() with base 10: 'many'"),
]
GRPC_NO_UNIT = (3, "streaming needs exactly one generative unit in the graph (found 0)")


def _proc_children() -> dict:
    """ppid -> child pids, from ``/proc/<pid>/stat``."""
    kids: dict = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        kids.setdefault(ppid, []).append(int(d))
    return kids


def descendants(pid: int) -> list[int]:
    """``pid`` and every process below it."""
    kids, out, todo = _proc_children(), [], [pid]
    while todo:
        p = todo.pop()
        out.append(p)
        todo.extend(kids.get(p, []))
    return out


def _socket_inodes(pid: int) -> set:
    out = set()
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return out
    for fd in fds:
        try:
            link = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if link.startswith("socket:["):
            out.add(int(link[8:-1]))
    return out


def _tcp_sockets() -> list:
    """(local port, remote port, state, inode) of each TCP socket of this
    network namespace (``/proc/net/tcp`` and ``tcp6``)."""
    rows = []
    for name in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(name) as f:
                lines = f.read().splitlines()[1:]
        except OSError:
            continue
        for line in lines:
            f = line.split()
            rows.append((int(f[1].rsplit(":", 1)[1], 16), int(f[2].rsplit(":", 1)[1], 16),
                         int(f[3], 16), int(f[9])))
    return rows


def socket_owners(pids, port: int, peer_port: int | None = None) -> set:
    """The processes among ``pids`` holding a socket on local ``port``: a
    listening one, or with ``peer_port`` the one accepted from that
    client port."""
    inodes = {ino for lp, rp, st, ino in _tcp_sockets()
              if lp == port and (st == 0x0A if peer_port is None else rp == peer_port)}
    return {p for p in pids if _socket_inodes(p) & inodes}


def _grpc_prompt(tokens, max_new: int = MAX_NEW, **extra) -> bytes:
    from seldon_core_tpu_torch.proto import prediction as pb

    return pb.SeldonMessage(strData=json.dumps(
        {"tokens": list(tokens), "max_new_tokens": max_new, **extra})).SerializeToString()


def _grpc_tokens(raw: bytes) -> list[int] | None:
    from seldon_core_tpu_torch.proto import prediction as pb

    msg = pb.SeldonMessage.FromString(raw)
    return json.loads(msg.strData)["tokens"] if msg.strData else None


async def _grpc_calls(port: int, raws, metadata=(), path: str = GRPC_PREDICT) -> list[bytes]:
    """Concurrent unary calls over one channel -> the raw replies."""
    from seldon_core_tpu_torch.wire import FastGrpcChannel

    ch = FastGrpcChannel(f"127.0.0.1:{port}")
    try:
        return list(await asyncio.gather(*(ch.call(path, r, timeout=600, metadata=metadata)
                                           for r in raws)))
    finally:
        await ch.close()


async def _grpc_stream(port: int, raw: bytes, metadata=(), drop_after: int | None = None
                       ) -> dict:
    """StreamPredict -> its messages' JSON and its failure (status, text);
    ``drop_after`` messages in, the connection is aborted (no RST)."""
    from seldon_core_tpu_torch.proto import prediction as pb
    from seldon_core_tpu_torch.wire import FastGrpcChannel, GrpcCallError

    ch = FastGrpcChannel(f"127.0.0.1:{port}")
    msgs, err = [], None
    try:
        async for m in ch.call_stream(GRPC_STREAM, raw, timeout=600, metadata=metadata):
            msgs.append(json.loads(pb.SeldonMessage.FromString(m).strData))
            if drop_after is not None and len(msgs) >= drop_after:
                ch._conn.transport.abort()
                break
    except GrpcCallError as e:
        err = (e.status, e.message)
    except ConnectionError:
        pass
    finally:
        await ch.close()
    return {"msgs": msgs, "err": err}


def _stream_tokens(out: dict) -> list[int] | None:
    msgs = out["msgs"]
    if out["err"] is not None or not msgs or not msgs[-1].get("done"):
        return None
    toks = [m["token"] for m in msgs[:-1]]
    return toks if toks == msgs[-1]["tokens"] else None


def _status_of(raw: bytes) -> tuple:
    from seldon_core_tpu_torch.proto import prediction as pb

    st = pb.SeldonMessage.FromString(raw).status
    return (st.code, st.info, st.status) if st is not None else None


def _rest_exchange_owner(port: int, body: bytes, pids) -> tuple[int, set]:
    """One POST on a fresh connection -> (status, the processes that hold
    its accepted socket)."""
    import socket

    sock = socket.create_connection(("127.0.0.1", port), timeout=60)
    try:
        sock.sendall(f"POST /api/v0.1/predictions HTTP/1.1\r\nhost: smoke\r\n"
                     f"content-length: {len(body)}\r\n\r\n".encode() + body)
        data = b""
        while b"\r\n\r\n" not in data:
            data += sock.recv(65536)
        head, _, rest = data.partition(b"\r\n\r\n")
        n = next(int(ln.split(b":")[1]) for ln in head.split(b"\r\n")
                 if ln.lower().startswith(b"content-length"))
        while len(rest) < n:
            rest += sock.recv(65536)
        return int(head.split(b" ")[1]), socket_owners(pids, port, sock.getsockname()[1])
    finally:
        sock.close()


async def _grpc_exchange_owner(port: int, raw: bytes, pids) -> tuple[tuple, set]:
    """One Predict on a fresh channel -> (its status, the processes that
    hold its accepted socket)."""
    from seldon_core_tpu_torch.wire import FastGrpcChannel

    ch = FastGrpcChannel(f"127.0.0.1:{port}")
    try:
        reply = await ch.call(GRPC_PREDICT, raw, timeout=60)
        local = ch._conn.transport.get_extra_info("sockname")[1]
        return _status_of(reply), await asyncio.to_thread(socket_owners, pids, port, local)
    finally:
        await ch.close()


def phase_serve_grpc(serve: dict, device: str = "cuda", preset: str = SERVE_PRESET,
                     seed: int = 0) -> dict:
    """The gRPC plane, through the port's own client (``FastGrpcChannel``;
    the card has no grpcio).  G1: one llama3-1b bf16 engine with a gRPC
    port: ``Seldon/Predict`` over ``serve``'s prompts and ``StreamPredict``
    equal the REST replies and the SSE stream of the same prompts, the JAX
    refusals answer status 3 with the JAX texts, the ``engine-grpc`` edge
    counts the client's bytes.  G2: the port's gateway (``--grpc-port``) in
    front of it: Predict and StreamPredict with a valid ``oauth_token``
    equal the direct calls, a missing or wrong token gives the JAX status
    and message, the ``gateway-grpc`` edge counts the client's framed
    bytes, one ``traceparent`` reaches the engine's timeline, and a client
    that drops its connection mid-StreamPredict frees the engine's slot
    long before its ``max_new_tokens``.  G3: R1's Iris and R2's transform
    pipeline behind GRPC nodes (the runtime's CLI with ``GRPC``) answer as
    the same graphs of REST nodes; a ResNet-50 ``JAX_MODEL`` unit answers a
    16-image uint8 rawTensor over gRPC bit for bit as over REST (one wave's
    predictions/s over each front is printed, a record).  G4: a
    SIMPLE_MODEL engine through its CLI with ``--workers 2`` and
    ``SELDON_DEPLOYMENT_ID``: both processes listen on both ports, fresh
    connections on each front are answered by both, and its
    ``engine-grpc`` edge carries the deployment's name.  Returns the
    kernels' launches on the gRPC paths (REST and SSE references off)."""
    import base64

    import numpy as np

    from seldon_core_tpu_torch.obs import TIMELINE, WIRE, WIRE_ENGINE_GRPC
    from seldon_core_tpu_torch.ops import _build
    from seldon_core_tpu_torch.proto import prediction as pb
    from seldon_core_tpu_torch.runtime.server import MicroserviceApp

    prompts = serve["prompts"]
    rec: dict = {"phase": "serve_grpc", "card": _card(), "preset": preset, "dtype": "bfloat16"}
    launches = {name: 0 for name in KERNELS}
    reference_launches = {name: 0 for name in KERNELS}
    tmp = tempfile.mkdtemp(prefix="sct-grpc-")
    iris_dir = os.path.join(ROOT, "examples", "iris")
    pipe_dir = os.path.join(ROOT, "examples", "transform-pipeline")
    iris = _load_example("examples/iris/IrisClassifier.py", "iris_example")
    pipe = _load_example("examples/transform-pipeline/pipeline.py", "pipeline_example")
    with open(os.path.join(pipe_dir, "graph.json")) as f:
        pipe_graph = json.load(f)["graph"]

    async def reference(aw):
        before = dict(_build.LAUNCHES)
        try:
            return await aw
        finally:
            for name in KERNELS:
                reference_launches[name] += _build.LAUNCHES[name] - before[name]

    def check(key: str, gate: bool) -> None:
        rec[key]["ok"] = bool(gate)
        if not gate:
            raise AssertionError(f"serve_grpc {key}: {rec[key]}")

    async def run() -> None:
        t_phase = time.perf_counter()
        # the children boot while the engine warms: G3's gRPC microservices
        # and G4's engine processes
        kids = _Children(tmp)
        iris_port = kids.start("iris", "IrisClassifier", "MODEL", iris_dir, api="GRPC")
        pipe_ports = {name: kids.start(name, f"pipeline.{cls}", kind, pipe_dir, api="GRPC")
                      for name, cls, kind in (("standardize", "Standardize", "TRANSFORMER"),
                                              ("scorer", "Scorer", "MODEL"),
                                              ("label", "ArgmaxLabel", "TRANSFORMER"))}
        w_port, w_grpc = _free_port(), _free_port()
        simple = {"name": "default", "graph": {"name": "m", "type": "MODEL",
                                               "implementation": "SIMPLE_MODEL"}}
        w_log = open(os.path.join(tmp, "workers.log"), "ab")
        workers = subprocess.Popen(
            [sys.executable, "-m", "seldon_core_tpu_torch.engine.app", "--host", "127.0.0.1",
             "--port", str(w_port), "--grpc-port", str(w_grpc), "--workers", str(GRPC_WORKERS),
             "--device", device],
            cwd=ROOT, stdout=w_log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": ROOT, "SELDON_DEPLOYMENT_ID": GRPC_DEPLOYMENT,
                 "ENGINE_PREDICTOR": base64.b64encode(json.dumps(simple).encode()).decode()})
        apps, gw = [], None
        try:
            e, e_boot = await _boot(_serve_spec(preset, seed), device, grpc_port=0)
            apps.append(e)
            rec["ready_s"] = e_boot
            model = e.service.walker.component.model
            wire = WIRE.counter(WIRE_ENGINE_GRPC, e.service.deployment_name)
            _build.reset_launches()  # the gRPC paths' run starts here

            # -- G1: the engine's gRPC service
            raws = [_grpc_prompt(p) for p in prompts]
            w0 = (wire.requests, wire.bytes_in, wire.bytes_out)
            t0 = time.perf_counter()
            replies = await _grpc_calls(e.grpc_port, raws)
            grpc_s = time.perf_counter() - t0
            w1 = (wire.requests, wire.bytes_in, wire.bytes_out)
            grpc_toks = [_grpc_tokens(r) for r in replies]
            t0 = time.perf_counter()
            rest = await reference(_requests(e.port, [_body(p) for p in prompts]))
            rest_s = time.perf_counter() - t0
            rest_toks = [json.loads(json.loads(r["raw"])["strData"])["tokens"]
                         if r["status"] == 200 else None for r in rest]
            stream = await _grpc_stream(e.grpc_port, raws[0])
            sse = await reference(asyncio.to_thread(
                _sse, e.port, {"tokens": list(prompts[0]), "max_new_tokens": MAX_NEW}))
            sse_toks = [ev["token"] for ev in sse["events"] if "token" in ev]
            refusals = [await _grpc_stream(e.grpc_port, (
                pb.SeldonMessage(binData=b"x") if body is None
                else pb.SeldonMessage(strData=json.dumps(body))).SerializeToString())
                for body, _, _ in GRPC_REFUSALS]
            rec["G1"] = {
                "requests": len(raws), "wave_s": grpc_s, "rest_wave_s": rest_s,
                "tokens_equal_rest": sum(int(g is not None and g == r)
                                         for g, r in zip(grpc_toks, rest_toks)),
                "tokens_equal_serve": sum(int(g == w) for g, w in zip(grpc_toks, serve["outs"]))
                if serve.get("outs") else None,
                "stream_equal_predict": _stream_tokens(stream) == grpc_toks[0],
                "stream_equal_sse": _stream_tokens(stream) == sse_toks,
                "refusals": [r["err"] for r in refusals],
                "wire": {"requests": w1[0] - w0[0], "bytes_in": w1[1] - w0[1],
                         "bytes_out": w1[2] - w0[2], "client_sent": sum(map(len, raws)),
                         "client_received": sum(map(len, replies))}}
            g1 = rec["G1"]
            check("G1", g1["tokens_equal_rest"] == len(raws) and g1["stream_equal_predict"]
                  and g1["tokens_equal_serve"] in (None, len(raws))
                  and g1["stream_equal_sse"]
                  and g1["refusals"] == [(st, text) for _, st, text in GRPC_REFUSALS]
                  and g1["wire"]["requests"] == len(raws)
                  and (g1["wire"]["bytes_in"], g1["wire"]["bytes_out"])
                  == (g1["wire"]["client_sent"], g1["wire"]["client_received"]))

            # -- G2: the gateway's gRPC relay in front of it
            deps = os.path.join(tmp, "deployments.json")
            with open(deps, "w") as f:
                json.dump([{"name": "chat", "oauth_key": "chat-key",
                            "oauth_secret": "chat-secret",
                            "endpoints": [{"host": "127.0.0.1", "rest_port": e.port,
                                           "grpc_port": e.grpc_port}]}], f)
            gw = _GatewayProc(tmp, "gateway", deps, {})
            rec["gateway_ready_s"] = await asyncio.to_thread(gw.wait_ready)
            tok = json.loads((await asyncio.to_thread(
                _http, gw.port, "POST", "/oauth/token",
                b"grant_type=client_credentials&client_id=chat-key&client_secret=chat-secret",
                {"content-type": "application/x-www-form-urlencoded"}))["body"])["access_token"]
            auth = (("oauth_token", tok),)
            gw_wire0 = _json_get(gw.port, "/stats/wire")["wire"]["stages"].get("gateway-grpc", {})
            via = await _grpc_calls(gw.grpc_port, raws, auth)
            gw_wire1 = _json_get(gw.port, "/stats/wire")["wire"]["stages"]["gateway-grpc"]["chat"]
            via_stream = await _grpc_stream(gw.grpc_port, raws[0], auth)
            no_token = (await _grpc_calls(gw.grpc_port, raws[:1]))[0]
            bad_token = (await _grpc_calls(gw.grpc_port, raws[:1],
                                           (("oauth_token", "nope"),)))[0]
            stream_no_token = await _grpc_stream(gw.grpc_port, raws[0])
            tp = _traceparent()
            traced = (await _grpc_calls(gw.grpc_port, raws[1:2],
                                        auth + (("traceparent", tp),)))[0]
            timelines = TIMELINE.by_trace(tp.split("-")[1])
            free0, emitted0 = model.free_block_count, model.tokens_emitted
            t_drop = time.perf_counter()
            dropped = await _grpc_stream(gw.grpc_port,
                                         _grpc_prompt(VERIFY_PROMPT, GRPC_DROP_NEW),
                                         auth, drop_after=GRPC_DROP_AFTER)
            while model.free_block_count != free0 and time.perf_counter() - t_drop < 30:
                await asyncio.sleep(0.01)
            freed_s = time.perf_counter() - t_drop
            before = gw_wire0.get("chat", {"requests": 0, "bytes_in": 0, "bytes_out": 0})
            rec["G2"] = {
                "predict_equal_direct": sum(int(_grpc_tokens(v) == g)
                                            for v, g in zip(via, grpc_toks)),
                "stream_equal_direct": via_stream == stream,
                "no_token": _status_of(no_token), "bad_token": _status_of(bad_token),
                "stream_no_token": stream_no_token["err"],
                "wire": {"requests": gw_wire1["requests"] - before["requests"],
                         "bytes_in": gw_wire1["bytes_in"] - before["bytes_in"],
                         "bytes_out": gw_wire1["bytes_out"] - before["bytes_out"],
                         "client_framed_sent": sum(len(r) + 5 for r in raws),
                         "client_framed_received": sum(len(v) + 5 for v in via)},
                "traced_tokens_equal": _grpc_tokens(traced) == grpc_toks[1],
                "trace_timelines": len(timelines),
                "drop": {"max_new_tokens": GRPC_DROP_NEW, "received": len(dropped["msgs"]),
                         "emitted": model.tokens_emitted - emitted0,
                         "freed": model.free_block_count == free0, "freed_s": freed_s}}
            g2 = rec["G2"]
            check("G2", g2["predict_equal_direct"] == len(raws) and g2["stream_equal_direct"]
                  and g2["no_token"] == (401, "missing oauth_token metadata", pb.Status.FAILURE)
                  and g2["bad_token"] == (401, "invalid access token", pb.Status.FAILURE)
                  and g2["stream_no_token"] == (16, "missing oauth_token metadata")
                  and g2["wire"]["requests"] == len(raws)
                  and (g2["wire"]["bytes_in"], g2["wire"]["bytes_out"])
                  == (g2["wire"]["client_framed_sent"], g2["wire"]["client_framed_received"])
                  and g2["traced_tokens_equal"] and g2["trace_timelines"] >= 1
                  and g2["drop"]["received"] == GRPC_DROP_AFTER and g2["drop"]["freed"]
                  and g2["drop"]["emitted"] <= GRPC_DROP_NEW // 4)
            L1 = dict(_build.LAUNCHES)
            gw.stop()
            gw = None
            await e.close()
            apps.remove(e)

            # -- G3: graphs of GRPC nodes, and a zoo unit over both fronts
            rec["children_ready_s"] = await asyncio.to_thread(kids.wait_ready)
            rng = np.random.default_rng(seed + 16)
            rows = [rng.uniform(0.1, 8.0, size=(int(rng.integers(1, 9)), 4)).round(3)
                    for _ in range(GRPC_IRIS_REQUESTS)]
            iris_bodies = [{"data": {"names": ["sepal_length", "sepal_width", "petal_length",
                                               "petal_width"], "ndarray": r.tolist()}}
                           for r in rows]
            pipe_bodies = [{"data": {"ndarray": r.tolist()}} for r in rows[:GRPC_PIPE_REQUESTS]]
            twins = {"iris": MicroserviceApp(iris.IrisClassifier(), "iris", "MODEL"),
                     "standardize": MicroserviceApp(pipe.Standardize(), "standardize",
                                                    "TRANSFORMER"),
                     "scorer": MicroserviceApp(pipe.Scorer(), "scorer", "MODEL"),
                     "label": MicroserviceApp(pipe.ArgmaxLabel(), "label", "TRANSFORMER")}
            for t in twins.values():
                await t.start("127.0.0.1", 0)
            try:
                def node(kind, ports, name, unit_type, children=()):
                    return {"name": name, "type": unit_type, "children": list(children),
                            "endpoint": {"service_host": "127.0.0.1",
                                         "service_port": ports[name], "type": kind}}

                def rewrite(n, kind, ports):
                    return {**n, "endpoint": {**n["endpoint"], "type": kind,
                                              "service_port": ports[n["name"]]},
                            "children": [rewrite(c, kind, ports) for c in n.get("children", [])]}

                grpc_ports = {"iris": iris_port, **pipe_ports}
                rest_ports = {k: t.port for k, t in twins.items()}
                outs = {}
                for kind, ports in (("GRPC", grpc_ports), ("REST", rest_ports)):
                    for gname, graph, bodies in (
                            ("iris", node(kind, ports, "iris", "MODEL"), iris_bodies),
                            ("pipeline", rewrite(pipe_graph, kind, ports), pipe_bodies)):
                        app, _ = await _boot(_graph_spec(graph), device, grpc_port=0)
                        try:
                            got = [(st, {k: v for k, v in rep.items() if k != "meta"})
                                   for st, rep in (await _walls(app.port, bodies, 4))[0]]
                            extra = None
                            if gname == "iris" and kind == "GRPC":
                                extra = (await _grpc_stream(
                                    app.grpc_port, _grpc_prompt([1, 2])))["err"]
                        finally:
                            await app.close()
                        outs[(gname, kind)] = (got, extra)
                host = iris.IrisClassifier()
                iris_host = sum(int(st == 200 and np.array_equal(
                    np.asarray(rep["data"]["ndarray"]), host.predict(r, [])))
                    for (st, rep), r in zip(outs[("iris", "GRPC")][0], rows))
            finally:
                for t in twins.values():
                    await t.close()
            zoo = await _grpc_zoo(device, seed)
            rec["G3"] = {
                "iris_equal_rest_twin": outs[("iris", "GRPC")][0] == outs[("iris", "REST")][0],
                "iris_equal_host": iris_host, "iris_requests": len(rows),
                "pipeline_equal_rest_twin":
                    outs[("pipeline", "GRPC")][0] == outs[("pipeline", "REST")][0],
                "pipeline_statuses": sorted({st for st, _ in outs[("pipeline", "GRPC")][0]}),
                "no_generative_unit": outs[("iris", "GRPC")][1], **zoo}
            g3 = rec["G3"]
            check("G3", g3["iris_equal_rest_twin"] and g3["iris_equal_host"] == len(rows)
                  and g3["pipeline_equal_rest_twin"] and g3["pipeline_statuses"] == [200]
                  and tuple(g3["no_generative_unit"] or ()) == GRPC_NO_UNIT
                  and g3["resnet_bit_equal"] == GRPC_ZOO_REQUESTS)

            # -- G4: --workers 2 behind SO_REUSEPORT
            t0 = time.perf_counter()
            pids: set = set()
            while time.perf_counter() - t0 < REMOTE_READY_S:
                if workers.poll() is not None:
                    raise AssertionError(f"the worker engine exited with {workers.returncode}")
                tree = descendants(workers.pid)
                rest_l, grpc_l = socket_owners(tree, w_port), socket_owners(tree, w_grpc)
                if len(rest_l) == GRPC_WORKERS and rest_l == grpc_l:
                    pids = rest_l
                    try:
                        if _get(w_port, "/ready") == 200:
                            break
                    except (urllib.error.URLError, OSError):
                        pass
                await asyncio.sleep(0.2)
            body = json.dumps({"data": {"ndarray": [[1.0, 2.0, 3.0]]}}).encode()
            raw = _sm_ndarray([[1.0, 2.0, 3.0]])
            rest_owners, grpc_owners, statuses = [], [], set()
            for _ in range(GRPC_WORKER_CONNS):
                st, owner = await asyncio.to_thread(_rest_exchange_owner, w_port, body, pids)
                statuses.add(("rest", st))
                rest_owners.append(sorted(owner))
                gst, gowner = await _grpc_exchange_owner(w_grpc, raw, pids)
                statuses.add(("grpc", gst[0] if gst else None))
                grpc_owners.append(sorted(gowner))
            wire_stages = _json_get(w_port, "/stats/wire")["wire"]["stages"]
            rec["G4"] = {
                "workers": GRPC_WORKERS, "listening_pids": len(pids),
                "listen_s": time.perf_counter() - t0,
                "rest_answered_by": len({o[0] for o in rest_owners if len(o) == 1}),
                "grpc_answered_by": len({o[0] for o in grpc_owners if len(o) == 1}),
                "rest_per_process": sorted(
                    sum(o == [p] for o in rest_owners) for p in pids),
                "grpc_per_process": sorted(
                    sum(o == [p] for o in grpc_owners) for p in pids),
                "connections": GRPC_WORKER_CONNS, "statuses": sorted(statuses),
                "engine_grpc_names": sorted(wire_stages.get("engine-grpc", {})),
                "engine_rest_names": sorted(wire_stages.get("engine-rest", {}))}
            g4 = rec["G4"]
            check("G4", g4["listening_pids"] == GRPC_WORKERS
                  and g4["rest_answered_by"] == g4["grpc_answered_by"] == GRPC_WORKERS
                  and all(len(o) == 1 for o in rest_owners + grpc_owners)
                  and g4["statuses"] == [("grpc", 200), ("rest", 200)]
                  and g4["engine_grpc_names"] == [GRPC_DEPLOYMENT]
                  and g4["engine_rest_names"] == [GRPC_DEPLOYMENT])

            for name in KERNELS:
                launches[name] = L1.get(name, 0) - reference_launches[name]
            rec["launches"] = launches
            rec["reference_launches"] = reference_launches
            rec["seconds"] = time.perf_counter() - t_phase
            rec["ok"] = all(n > 0 for n in launches.values())
            if not rec["ok"]:
                raise AssertionError(f"serve_grpc: a kernel never launched: {launches}")
        except BaseException:
            rec.setdefault("ok", False)
            rec["gateway_log"] = gw.tail()[-800:] if gw is not None else None
            raise
        finally:
            emit(rec)
            if gw is not None:
                gw.stop()
            for app in apps:
                await app.close()
            kids.close()
            workers.terminate()
            try:
                workers.wait(timeout=20)
            except subprocess.TimeoutExpired:
                workers.kill()
                workers.wait()
            w_log.close()

    try:
        asyncio.run(run())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def _sm_ndarray(rows) -> bytes:
    from seldon_core_tpu_torch.contract import Payload, payload_to_proto

    import numpy as np

    return payload_to_proto(Payload.from_array(np.asarray(rows))).SerializeToString()


async def _grpc_zoo(device: str, seed: int) -> dict:
    """G3's zoo unit: ResNet-50 (uint8 input, buckets 16 and 32) answering
    the same 16-image rawTensor requests over REST and over gRPC, one wave
    each; -> the bit-equality count and each front's predictions/s."""
    import base64

    import numpy as np

    from seldon_core_tpu_torch.contract import Payload, payload_to_proto
    from seldon_core_tpu_torch.contract.payload import DataKind
    from seldon_core_tpu_torch.proto import prediction as pb

    rng = np.random.default_rng(seed + 17)
    cfg = _zoo_cfg("resnet")
    images = [_zoo_rows("resnet", cfg, GRPC_ZOO_IMAGES, rng) for _ in range(GRPC_ZOO_REQUESTS)]
    unit = _zoo_unit("res", "resnet", 0, input_dtype=("uint8", "STRING"),
                     buckets=("16,32", "STRING"))
    app, boot_s = await _boot(_graph_spec(unit), device, grpc_port=0)
    try:
        bodies = [_raw_body(x) for x in images]
        raws = [payload_to_proto(Payload(x, [], DataKind.RAW)).SerializeToString()
                for x in images]
        await _graph_wave(app.port, bodies[:1])  # the connections' warmup
        await _grpc_calls(app.grpc_port, raws[:1])
        t0 = time.perf_counter()
        rest, _, _ = await _graph_wave(app.port, bodies)
        rest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        replies = await _grpc_calls(app.grpc_port, raws)
        grpc_s = time.perf_counter() - t0
    finally:
        await app.close()
    equal = 0
    for (code, rep), raw in zip(rest, replies):
        rt = pb.SeldonMessage.FromString(raw).rawTensor
        want = rep.get("rawTensor") if code == 200 else None
        equal += int(rt is not None and want is not None and rt.dtype == want["dtype"]
                     and list(rt.shape) == want["shape"]
                     and rt.data == base64.b64decode(want["data"]))
    n = GRPC_ZOO_REQUESTS * GRPC_ZOO_IMAGES
    print(f"serve_grpc G3: ResNet-50 {n} images in {GRPC_ZOO_REQUESTS} concurrent requests: "
          f"REST {n / rest_s:.1f} predictions/s, gRPC {n / grpc_s:.1f} predictions/s "
          f"({_card()})", flush=True)
    return {"resnet_boot_s": boot_s, "resnet_bit_equal": equal,
            "resnet_rest_predictions_s": n / rest_s,
            "resnet_grpc_predictions_s": n / grpc_s}


def _flash_times(fa, S: int, D: int = 64) -> dict:
    """K1 at B=1, S, llama3-1b heads (32 and 8 KV; ``D`` 128 is the 8b's
    geometry), bf16: one input set per layer so no launch finds its inputs
    in L2."""
    import torch

    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, KV, layers = 32, 8, 16
    sets = [_flash_inputs(S, H, KV, D, torch.bfloat16, seed=100 + i) for i in range(layers)]
    bhsd = [tuple(x.transpose(1, 2).contiguous() for x in s) for s in sets]
    nbytes = 2 * (2 * S * H * D + 2 * S * KV * D)
    flops = 4 * D * H * S * (S + 1) / 2
    b_ms, b_by = bound(nbytes, flops)
    return {
        "shape": {"B": 1, "S": S, "H": H, "KV": KV, "D": D, "dtype": "bfloat16"},
        "ms": time_ms(fa.flash_causal_attention_blhd, sets),
        "eager_ms": eager_ms(fa.flash_causal_attention_blhd, sets),
        "host_ms": host_ms(fa.flash_causal_attention_blhd, sets),
        "plain_ms": time_ms(lambda q, k, v: fa._attention_blhd_plain(q, k, v, True), sets, 5),
        "library_ms": time_ms(
            lambda q, k, v: sdpa(q, k, v, is_causal=True, enable_gqa=True), bhsd),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
    }


def _flash_suffix_times(fa, Sq: int, Sk: int) -> dict:
    """K1's bottom-right causal variant, a suffix prefill's attention: Sq
    suffix rows over Sk = prefix + Sq keys, llama3-1b heads, bf16; the
    library call is SDPA with the lower-right causal mask."""
    import torch
    from torch.nn.attention.bias import causal_lower_right

    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, KV, D, layers = 32, 8, 64, 16
    sets = []
    for i in range(layers):
        q, k, v = _flash_inputs(Sk, H, KV, D, torch.bfloat16, seed=300 + i)
        sets.append((q[:, -Sq:].contiguous(), k, v))
    bhsd = [tuple(x.transpose(1, 2).contiguous() for x in s) for s in sets]
    mask = causal_lower_right(Sq, Sk)
    nbytes = 2 * (2 * Sq * H * D + 2 * Sk * KV * D)
    flops = 4 * D * H * sum(Sk - Sq + i + 1 for i in range(Sq))
    b_ms, b_by = bound(nbytes, flops)
    return {
        "shape": {"B": 1, "Sq": Sq, "Sk": Sk, "H": H, "KV": KV, "D": D, "dtype": "bfloat16"},
        "ms": time_ms(fa.flash_causal_attention_blhd, sets),
        "eager_ms": eager_ms(fa.flash_causal_attention_blhd, sets),
        "host_ms": host_ms(fa.flash_causal_attention_blhd, sets),
        "plain_ms": time_ms(lambda q, k, v: fa._attention_blhd_plain(q, k, v, True), sets, 5),
        "library_ms": time_ms(
            lambda q, k, v: sdpa(q, k, v, attn_mask=mask, enable_gqa=True), bhsd),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
    }


def _paged_times(pa, pos: list[int], WB: int, quant: bool = False, L: int = 1,
                 D: int = 64) -> dict:
    """K2: one decode step's read (``L`` = 1) or one verify pass's (``L``
    queries per slot) for SERVE_SLOTS slots at ``pos`` over a ``WB``-entry
    window, bf16 queries over bf16 pages or (``quant``) over int8 pages
    with bf16 scales, one pool per layer as in the model; ``D`` 128 is the
    8b's head dim."""
    import torch

    H, KV, BS, layers = 32, 8, 16, 16
    NB = 1 + SERVE_SLOTS * WB
    sets = []
    for i in range(layers):
        (q, k, v, table, p), kw = _paged_inputs(SERVE_SLOTS, L, H, KV, D, BS, NB, WB,
                                                torch.bfloat16, seed=200 + i, pos=pos,
                                                quant=quant)
        sets.append((q, k, v, table, p) + ((kw["k_scale"], kw["v_scale"]) if quant else ()))

    def kernel(*args):
        return pa.paged_decode_attention(*args[:5], k_scale=args[5], v_scale=args[6])

    def plain(*args):
        return pa.paged_decode_attention_plain(*args[:5], k_scale=args[5], v_scale=args[6])

    if not quant:  # the bf16 rows time the wrappers themselves, as before
        kernel, plain = pa.paged_decode_attention, pa.paged_decode_attention_plain

    # the function needs rows [0, pos + L - 1] of each slot (int8 rows carry
    # a bf16 scale per KV head) and the table entries of the pages that
    # hold them, whatever L is; the kernel reads them once per 4-row chunk
    # of the L * groups query rows
    rows = sum(p + L for p in pos)
    pages = sum((p + L - 1) // BS + 1 for p in pos)
    row_bytes = KV * (D + 2) if quant else 2 * KV * D
    nbytes = 2 * 2 * SERVE_SLOTS * L * H * D + 2 * rows * row_bytes + 4 * pages + 4 * SERVE_SLOTS
    flops = sum(4 * H * D * (p + j + 1) for p in pos for j in range(L))
    chunks = -(-L * (H // KV) // getattr(pa, "ROWS_PER_BLOCK", 4))
    b_ms, b_by = bound(nbytes, flops)
    return {
        "shape": {"S": SERVE_SLOTS, "L": L, "H": H, "KV": KV, "D": D, "BS": BS, "WB": WB,
                  "pos": pos, "dtype": "bfloat16", "pages": "int8" if quant else "bfloat16"},
        "chunks": chunks, "kv_bytes_needed": 2 * rows * row_bytes,
        "kv_bytes_read": chunks * 2 * rows * row_bytes,
        "ms": time_ms(kernel, sets),
        "eager_ms": eager_ms(kernel, sets),
        "host_ms": host_ms(kernel, sets),
        "plain_ms": time_ms(plain, sets, 5),
        "library_ms": None,  # no single PyTorch call reads a paged pool
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
    }


def window_entries(pos: list[int], rows_per_step: int = 1) -> int:
    """The table entries of the window bucket the scheduler picks for slots
    at ``pos`` (16-row pages) before a block of ``rows_per_step`` rows a
    step (``1 + spec_draft`` in a speculative block)."""
    window = 64
    while window < max(pos) + SERVE_BLOCK * rows_per_step + 1:
        window *= 2
    return window // 16


def kernel_times(fa, pa, bucket: int, pos: list[int]) -> dict:
    """Each kernel at the main path's shapes (``served``: the flash bucket
    and the served slots' positions) and a long one (``long``); the paged
    kernel also over int8 pages at both."""
    try:
        suffix = _flash_suffix_times(fa, 80, CACHED_PREFIX + 80)
    except ValueError:  # a tree whose flash attention has no bottom-right causal variant
        suffix = None
    return {
        "flash_attention": {"served": _flash_times(fa, bucket), "long": _flash_times(fa, 2048),
                            "suffix": suffix, "served_D128": _flash_times(fa, bucket, D=128)},
        "paged_decode_attention": {
            "served": _paged_times(pa, pos, window_entries(pos)),
            "long": _paged_times(pa, LONG_POS, 128),
            "served_int8": _paged_times(pa, pos, window_entries(pos), quant=True),
            "long_int8": _paged_times(pa, LONG_POS, 128, quant=True),
            "served_L4": _paged_times(pa, pos, window_entries(pos, 1 + SPEC_DRAFT),
                                      L=1 + SPEC_DRAFT),
            "long_L4": _paged_times(pa, LONG_POS, 128, L=1 + SPEC_DRAFT),
            "served_D128": _paged_times(pa, pos, window_entries(pos), D=128),
        },
    }


def phase_kernel_times(serve: dict) -> dict:
    """Each kernel at the main path's shapes (``served``) and a long one
    (``long``): kernel, plain version, one library call where there is one,
    and the bound."""
    fa = importlib.import_module("seldon_core_tpu_torch.ops.flash_attention")
    pa = importlib.import_module("seldon_core_tpu_torch.ops.paged_attention")
    # K1 at the largest bucket the served prompts used; K2 for the served
    # slots at their mid-answer positions over the scheduler's window bucket
    out = kernel_times(fa, pa, serve["bucket"], serve["pos"])
    if out["flash_attention"]["suffix"] is None:
        raise AssertionError("flash attention refused its bottom-right causal variant")
    for t in out["paged_decode_attention"].values():
        t["splits"], t["per"] = pa.plan_splits(t["shape"]["WB"])
        t["grid_blocks"] = t["splits"] * t["shape"]["KV"] * t["chunks"] * SERVE_SLOTS
    emit({"phase": "kernel_times", **out})
    return {name: t["served"] for name, t in out.items()}


# each kernel's source and the TPU kernel it replaces (provenance strings;
# nothing of the JAX package is imported)
KERNELS = {
    "flash_attention": ("seldon_core_tpu_torch/csrc/flash_attention.cu",
                        "seldon_core_tpu/ops/flash_attention.py:86"),
    "paged_decode_attention": ("seldon_core_tpu_torch/csrc/paged_attention.cu",
                               "seldon_core_tpu/ops/paged_attention.py:109"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    seconds: dict = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - t0

    timed("build", phase_build)
    errs = timed("kernel_check", phase_kernel_check)
    timed("reference", phase_reference)
    timed("graphs", phase_graphs)
    serve = timed("serve", phase_serve)
    cached = timed("serve_cached", phase_serve_cached)
    spec = timed("serve_spec", phase_serve_spec, serve)
    split = timed("serve_disagg", phase_serve_disagg, serve)
    stream = timed("serve_stream", phase_serve_stream)
    graph = timed("serve_graph", phase_serve_graph, serve)
    lora = timed("serve_lora", phase_serve_lora, serve)
    zoo = timed("serve_zoo", phase_serve_zoo)
    tiers = timed("serve_cache", phase_serve_cache, serve)
    admission = timed("serve_qos", phase_serve_qos, serve)
    remote = timed("serve_remote", phase_serve_remote, serve)
    pack = timed("serve_pack", phase_serve_pack)
    obs = timed("serve_obs", phase_serve_obs)
    ckpt = timed("serve_checkpoint", phase_serve_checkpoint, serve, spec, pack)
    gateway = timed("serve_gateway", phase_serve_gateway, serve)
    grpc_plane = timed("serve_grpc", phase_serve_grpc, serve)
    times = timed("kernel_times", phase_kernel_times, serve)
    emit({"phase_seconds": seconds, "total_s": sum(seconds.values())})
    launches = {name: serve["launches"][name] + cached["launches"][name] + spec[name]
                + split[name] + stream[name] + graph[name] + lora[name] + zoo[name]
                + tiers[name] + admission[name] + remote[name] + pack[name] + obs[name]
                + ckpt[name] + gateway[name] + grpc_plane[name] for name in KERNELS}
    print(_card(), flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": origin,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
         "library_ms": times[name]["library_ms"]}
        for name, (src, origin) in KERNELS.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
