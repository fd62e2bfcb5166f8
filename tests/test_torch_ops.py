"""The PyTorch port's attention ops against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version (the CUDA
kernels build and run only on the card, where ``chip_smoke.py`` holds them
against these same plain versions).  The JAX side runs its Pallas kernels
in interpret mode, as ``tests/test_ops.py`` does.  Inputs come from seeded
numpy and are fed to both frameworks; tolerance rtol = atol = 2e-5 in f32
(the same sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.llama import _dense_causal_attention as jax_dense_causal
from seldon_core_tpu.models.llama import _gqa_repeat as jax_gqa_repeat
from seldon_core_tpu.ops import flash_attention as jax_flash
from seldon_core_tpu.ops import flash_causal_attention_blhd as jax_blhd
from seldon_core_tpu.ops import paged_decode_attention as jax_paged
from seldon_core_tpu_torch import ops
from seldon_core_tpu_torch.ops import paged_attention as paged_ops

TOL = dict(rtol=2e-5, atol=2e-5)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


class TestFlashAttention:
    @pytest.mark.parametrize("shape", [(1, 2, 128, 64), (1, 1, 64, 128)])
    @pytest.mark.parametrize("causal", [True, False])
    def test_matches_pallas_kernel(self, shape, causal):
        rng = np.random.default_rng(0)
        q, k, v = (_normal(rng, *shape) for _ in range(3))
        want = jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal, block_q=64, block_k=64)
        got = ops.flash_attention(*_t(q, k, v), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    @pytest.mark.parametrize("seq", [48, 97, 120])
    def test_blhd_matches_pallas_adapter(self, seq):
        # 97 is prime: the JAX adapter tiles it as one 97-row block, the
        # port needs no tile that divides S
        rng = np.random.default_rng(seq)
        q, k, v = (_normal(rng, 2, seq, 4, 32) for _ in range(3))
        want = jax_blhd(*map(jnp.asarray, (q, k, v)))
        got = ops.flash_causal_attention_blhd(*_t(q, k, v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_prime_length_past_one_tile_matches_dense(self):
        # 131: the Pallas adapter would degrade to 1-row tiles; the port
        # is pinned to the dense reference the adapter is held to
        rng = np.random.default_rng(131)
        q, k, v = (_normal(rng, 1, 131, 2, 16) for _ in range(3))
        want = jax_dense_causal(*map(jnp.asarray, (q, k, v)))
        got = ops.flash_causal_attention_blhd(*_t(q, k, v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    @pytest.mark.parametrize("n_heads,n_kv", [(8, 2), (6, 3)])
    def test_grouped_kv_equals_repeated_kv(self, n_heads, n_kv):
        """The port takes un-repeated K/V (KV divides H); the JAX adapter
        receives K/V repeated to H heads.  Both give the same attention."""
        rng = np.random.default_rng(n_heads * 10 + n_kv)
        q = _normal(rng, 1, 80, n_heads, 16)
        k, v = (_normal(rng, 1, 80, n_kv, 16) for _ in range(2))
        kf, vf = (jax_gqa_repeat(jnp.asarray(x), n_heads) for x in (k, v))
        want = jax_blhd(jnp.asarray(q), kf, vf)
        got = ops.flash_causal_attention_blhd(*_t(q, k, v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        repeated = ops.flash_causal_attention_blhd(*_t(q, np.asarray(kf), np.asarray(vf)))
        np.testing.assert_allclose(repeated.numpy(), got.numpy(), **TOL)

    @pytest.mark.parametrize("P,Ls,window", [(32, 16, 32), (48, 32, 64), (16, 80, 64),
                                             (96, 16, 128)])
    def test_bottom_right_variant_equals_the_suffix_prefills_einsum_route(self, P, Ls, window):
        """Sk > Sq: the queries are the last Ls rows of a causal prefill over
        P + Ls keys.  The suffix prefill's CPU route
        (``models/llama.py::prefill_suffix_paged``) attends a window of
        ``window >= P`` gathered prefix columns, those past P masked, then
        the suffix causally; the variant takes exactly the P prefix rows."""
        rng = np.random.default_rng(P * 1000 + Ls)
        H, KV, D = 8, 2, 16
        q = _normal(rng, 1, Ls, H, D)
        kp, vp = _normal(rng, 1, window, KV, D), _normal(rng, 1, window, KV, D)  # past P: junk
        ks, vs = _normal(rng, 1, Ls, KV, D), _normal(rng, 1, Ls, KV, D)
        got = ops.flash_causal_attention_blhd(
            *_t(q, np.concatenate([kp[:, :P], ks], 1), np.concatenate([vp[:, :P], vs], 1)))
        qt, kf, vf = _t(q, np.concatenate([kp, ks], 1), np.concatenate([vp, vs], 1))
        kf = kf.repeat_interleave(H // KV, dim=2)
        vf = vf.repeat_interleave(H // KV, dim=2)
        cols = torch.arange(Ls)
        mask = torch.cat([(torch.arange(window)[None, :] < P).expand(Ls, window),
                          cols[:, None] >= cols[None, :]], dim=1)
        sc = torch.einsum("bqhd,bkhd->bhqk", qt, kf) / np.sqrt(D)
        sc = sc.masked_fill(~mask, torch.finfo(sc.dtype).min)
        want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1), vf)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)

    def test_rejects_what_neither_version_takes(self):
        q = torch.zeros(1, 2, 16, 8)
        with pytest.raises(ValueError, match="at least as many keys as queries"):
            ops.flash_attention(q, torch.zeros(1, 2, 8, 8), torch.zeros(1, 2, 8, 8))
        with pytest.raises(ValueError, match="multiple of kv heads"):
            ops.flash_attention(torch.zeros(1, 3, 16, 8), q, q)


class TestPagedDecodeAttention:
    """The port's paged decode attention against the Pallas kernel, over the
    cases of ``tests/test_ops.py::TestPagedDecodeAttention``."""

    def _compare(self, S, L, KV, G, D, NB, BS, WB, *, quant=False, seed=0, pos=None):
        rng = np.random.default_rng(seed)
        H = KV * G
        q = _normal(rng, S, L, H, D)
        table = rng.integers(0, NB, (S, WB)).astype(np.int32)
        if pos is None:
            pos = rng.integers(0, WB * BS - L, S)  # deliberately off block boundaries
        pos = np.asarray(pos, np.int32)
        kw = {}
        if quant:
            k = rng.integers(-127, 128, (NB, BS, KV, D)).astype(np.int8)
            v = rng.integers(-127, 128, (NB, BS, KV, D)).astype(np.int8)
            kw = {
                "k_scale": (rng.random((NB, BS, KV)) * 0.1).astype(np.float32),
                "v_scale": (rng.random((NB, BS, KV)) * 0.1).astype(np.float32),
            }
        else:
            k, v = _normal(rng, NB, BS, KV, D), _normal(rng, NB, BS, KV, D)
        want = jax_paged(
            *map(jnp.asarray, (q, k, v, table, pos)),
            **{name: jnp.asarray(a) for name, a in kw.items()},
        )
        got = ops.paged_decode_attention(
            *_t(q, k, v, table, pos), **{name: _t(a)[0] for name, a in kw.items()}
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return got.numpy(), v

    @pytest.mark.parametrize("L", [1, 3, 5])
    def test_query_counts(self, L):
        self._compare(3, L, 2, 2, 16, 9, 16, 3, seed=L)

    @pytest.mark.parametrize("KV,G", [(1, 4), (2, 2), (3, 2), (4, 1)])
    def test_gqa_head_counts(self, KV, G):
        self._compare(2, 2, KV, G, 16, 7, 8, 3, seed=KV * 10 + G)

    @pytest.mark.parametrize("BS,WB", [(4, 7), (16, 2), (8, 5)])
    def test_positions_off_block_boundaries(self, BS, WB):
        self._compare(4, 2, 2, 2, 8, 11, BS, WB, seed=BS)

    @pytest.mark.parametrize("seed,shape", [(0, (3, 2, 2, 2, 16, 9, 16, 3)),
                                            (7, (2, 1, 2, 4, 8, 5, 4, 4))])
    def test_int8_pages(self, seed, shape):
        self._compare(*shape, quant=True, seed=seed)

    def test_zero_position_sees_one_row(self):
        rng = np.random.default_rng(3)
        q = _normal(rng, 2, 1, 4, 8)
        k, v = _normal(rng, 5, 4, 2, 8), _normal(rng, 5, 4, 2, 8)
        table = np.array([[1, 2], [3, 4]], np.int32)
        pos = np.zeros(2, np.int32)
        want = jax_paged(*map(jnp.asarray, (q, k, v, table, pos)))
        got = ops.paged_decode_attention(*_t(q, k, v, table, pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        # one visible row: attention returns exactly that row's v
        np.testing.assert_allclose(got.numpy()[0, 0, 0], v[1, 0, 0], **TOL)

    def test_rows_that_see_nothing_are_zeros(self):
        # pos = -1: no pool row is visible; the Pallas kernel writes zeros
        # there (its XLA reference would write a uniform softmax)
        got, _ = self._compare(2, 1, 2, 2, 8, 5, 4, 2, pos=[-1, -1])
        assert not got.any()


class TestSplitKV:
    """The split-KV decomposition of the paged decode kernel, on the CPU:
    the host planner, and per-split partials (the plain version's arithmetic
    restricted to each split's run of table entries) merged by log-sum-exp
    weights, as the kernel's last block merges them."""

    @pytest.mark.parametrize("WB", [64, 128, 7, 1, 3, 2048, 2, 16, 9])
    def test_planner_covers_each_entry_once(self, WB):
        splits, per = paged_ops.plan_splits(WB)
        runs = [range(s * per, min(WB, (s + 1) * per)) for s in range(splits)]
        assert all(len(r) for r in runs)  # no empty run
        assert sorted(i for r in runs for i in r) == list(range(WB))
        assert per >= 2 or WB < 2
        assert per <= paged_ops.PER_SPLIT

    def test_planner_reads_shapes_only(self):
        # the served decode step: 8 slots x 8 KV heads, window 1024, 16-row
        # pages -> at least two blocks per SM, from the window width alone
        splits, per = paged_ops.plan_splits(64)
        assert 8 * 8 * splits >= 2 * 132 and per >= 2
        assert paged_ops.plan_splits(3) == (1, 3)  # a small window: one split

    @pytest.mark.parametrize("WB", [16, 64, 128, 512])
    def test_split_size_does_not_follow_the_window(self, WB):
        # the window follows the batch's longest slot; a slot's split runs
        # (and so its summation order) must not
        assert paged_ops.plan_splits(WB)[1] == paged_ops.plan_splits(1024)[1]

    @staticmethod
    def _split_partials(q, k, v, table, pos, splits, per, k_scale=None, v_scale=None):
        """(m, l, acc) per split, the plain version's arithmetic over the
        split's pool rows: m the row max of the visible scores (-inf where
        none), l and acc the sums of exp(s - m) and exp(s - m) * v."""
        S, L, H, D = q.shape
        NB, BS, KV, _ = k.shape
        WB = table.shape[1]
        groups = H // KV
        idx = table.long()
        kw, vw = k[idx].float(), v[idx].float()
        if k_scale is not None:
            kw = kw * k_scale[idx][..., None].float()
            vw = vw * v_scale[idx][..., None].float()
        kw, vw = kw.reshape(S, WB * BS, KV, D), vw.reshape(S, WB * BS, KV, D)
        qg = q.float().reshape(S, L, KV, groups, D)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kw) / np.sqrt(D)  # (S, KV, G, L, W)
        col = torch.arange(WB * BS)
        visible = col[None, None, :] <= pos.long()[:, None, None] + torch.arange(L)[None, :, None]
        out = []
        for sp in range(splits):
            run = (col >= sp * per * BS) & (col < (sp + 1) * per * BS)
            ok = (visible & run[None, None, :])[:, None, None]  # (S, 1, 1, L, W)
            m = s.masked_fill(~ok, -np.inf).amax(-1)
            e = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None]) * ok
            out.append((m, e.sum(-1), torch.einsum("bkgqs,bskd->bkgqd", e, vw)))
        return out

    @staticmethod
    def _merge(partials, S, L, H, D):
        M = torch.stack([m for m, _, _ in partials]).amax(0)
        Mz = torch.where(torch.isinf(M), 0.0, M)
        w = [torch.exp(m - Mz) for m, _, _ in partials]  # exp(-inf) = 0 for empty splits
        lsum = sum(wi * li for wi, (_, li, _) in zip(w, partials))
        acc = sum(wi[..., None] * ai for wi, (_, _, ai) in zip(w, partials))
        o = torch.where(lsum[..., None] > 0, acc / lsum.clamp_min(1e-30)[..., None], 0.0)
        return o.permute(0, 3, 1, 2, 4).reshape(S, L, H, D)  # (S, KV, G, L, D) -> (S, L, H, D)

    @pytest.mark.parametrize("case", [
        dict(L=1, WB=16, pos=[0, 0, 0]),                  # position 0: one visible row
        dict(L=1, WB=16, pos=[3, 130, 255]),              # mixed lengths: empty later splits
        dict(L=3, WB=12, pos=[15, 16, 100]),              # on and off page edges
        dict(L=1, WB=16, pos=[-1, 40, -1]),               # inactive slots see nothing
        dict(L=3, WB=12, pos=[-2, 7, 180]),               # rows that see nothing beside rows that do
        dict(L=2, WB=16, pos=[9, 200, 31], quant=True),   # int8 pages
        dict(L=1, WB=2, pos=[5, 30, 0]),                  # one split
    ])
    def test_merged_splits_equal_the_unsplit_plain_version(self, case):
        rng = np.random.default_rng(case["WB"] * 10 + case["L"])
        S, L, KV, G, D, BS, WB = 3, case["L"], 2, 2, 16, 16, case["WB"]
        NB = 1 + S * WB
        H = KV * G
        q = _normal(rng, S, L, H, D)
        table = np.stack([rng.permutation(NB - 1)[:WB] + 1 for _ in range(S)]).astype(np.int32)
        kw = {}
        if case.get("quant"):
            k = rng.integers(-127, 128, (NB, BS, KV, D)).astype(np.int8)
            v = rng.integers(-127, 128, (NB, BS, KV, D)).astype(np.int8)
            kw = {n: _t((rng.random((NB, BS, KV)) * 0.05).astype(np.float32))[0]
                  for n in ("k_scale", "v_scale")}
        else:
            k, v = _normal(rng, NB, BS, KV, D), _normal(rng, NB, BS, KV, D)
        qt, kt, vt, tt, pt = _t(q, k, v, table, np.asarray(case["pos"], np.int32))
        splits, per = paged_ops.plan_splits(WB)
        assert (splits > 1) == (WB > 2)
        parts = self._split_partials(qt, kt, vt, tt, pt, splits, per, **kw)
        got = self._merge(parts, S, L, H, D)
        want = paged_ops.paged_decode_attention_plain(qt, kt, vt, tt, pt, **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_a_captured_graph_record_keeps_every_launch_split():
    """A capture's record moves what the wrappers counted (by kernel, by
    query positions and by head dim) off the counts, and each replay adds
    it back: the counts stay the kernels' real launches."""
    from seldon_core_tpu_torch.ops import _build

    _build.reset_launches()
    _build.LAUNCHES["paged_decode_attention"] += 3
    snap = _build.snapshot_launches()
    _build.LAUNCHES["paged_decode_attention"] += 2  # counted while "capturing"
    _build.PAGED_LAUNCHES_BY_L[4] += 2
    _build.LAUNCHES_BY_D["paged_decode_attention@128"] += 2
    record = _build.take_captured(snap)
    assert _build.LAUNCHES["paged_decode_attention"] == 3 and not _build.LAUNCHES_BY_D
    for _ in range(2):
        _build.add_launches(record)
    assert _build.LAUNCHES["paged_decode_attention"] == 7
    assert _build.PAGED_LAUNCHES_BY_L[4] == 4
    assert _build.LAUNCHES_BY_D["paged_decode_attention@128"] == 4
    _build.reset_launches()
