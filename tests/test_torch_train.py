"""Port parity: training on one device (loss, differentiable kernels,
optimizers, data, checkpoints, train step and driver).

* ``forward_train``: the loss (rtol 1e-5) and every gradient (max |diff|
  at most 1e-4 of the gradient's largest value) against
  ``jax.value_and_grad`` of ``repro.models.transformer.forward_train`` on
  the same weights (``models.convert``), tokens and stub inputs, in fp32,
  for the dense, ssm, cross and vlm smoke configs, with and without
  recomputation in backward.  The JAX package is called with no ambient
  mesh, where its sharding constraints do nothing (ROADMAP R1: its
  ``steps.build_cell`` fails under jax 0.9.0).  The fp32 work of the two
  packages differs only in summation order: a few ulps, far inside 1e-4.
* the differentiable kernel wrappers of ``kernels.ops``: on the CPU their
  gradients are those of the plain versions, and they also run under
  ``torch.inference_mode()``.
* AdamW and Adafactor: three updates on the same gradients against
  ``repro.optim.optimizers`` (rtol 1e-6: the same fp32 arithmetic).
* three full train steps against the reference's ``make_train_step``
  function called directly, with the default ``TrainConfig`` (rtol 1e-5:
  three steps of forward, backward and update, each a few ulps apart;
  see the test for why the default learning rate matters).
* the reference's ``TestOptimizers``, ``TestData`` and first three
  ``TestCheckpoint`` cases, ported and run on the port; the bigram table
  bit-equal to the reference's, and a checkpoint written by the reference
  restored by the port.
* the reference's ``TestTrainingLearns`` (loss falls on the bigram chain;
  a resumed run continues) on the port at its smoke width: the
  reference's own version fails under jax 0.9.0 (R1).
"""

import dataclasses
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_encdec_vlm import extras, port_config  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import tree as ttree  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs.base import (AttentionConfig, ModelConfig,  # noqa
                                      TrainConfig)
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import loss as tloss  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim.optimizers import (adafactor, adamw,  # noqa: E402
                                          cosine_schedule, global_norm,
                                          make_optimizer)

#: the four families' smoke configs: dense, ssm, cross (encoder-decoder)
#: and vlm
TRAIN_ARCHS = ["llama3-8b", "mamba2-370m", "whisper-tiny", "internvl2-1b"]
B, S = 2, 16


def _setup(arch, remat="minimal", seed=0):
    """(jax cfg, port cfg, jax params, port params, batch as NumPy) in
    fp32."""
    jcfg = dataclasses.replace(jreg.get_smoke_config(arch),
                               compute_dtype="float32", remat_policy=remat)
    tcfg = port_config(jcfg)
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = dict(extras(jcfg, B, rng), tokens=toks[:, :-1],
                 targets=toks[:, 1:])
    return jcfg, tcfg, jp, tp, batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v)) for k, v in batch.items()}


def _extras_kw(batch):
    return {k: batch[k] for k in ("extra_embeds", "audio_embeds")
            if k in batch}


def _close_leaves(got_tree, want_tree, rtol, what):
    paths = ttree.leaves_with_path(got_tree)
    want = jax.tree.leaves(want_tree)
    assert len(paths) == len(want)
    for (path, g), w in zip(paths, want):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape, (what, path)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()),
                                   err_msg=f"{what} {path}")


# ---------------------------------------------------------------------------
# forward_train: loss and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["none", "minimal"])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_forward_train_loss_and_grads_match_jax(arch, remat):
    jcfg, tcfg, jp, tp, batch = _setup(arch, remat)
    jb, tb = _jbatch(batch), _tbatch(batch)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.forward_train(p, jb["tokens"], jb["targets"], jcfg,
                                   **_extras_kw(jb)), has_aux=True))(jp)
    leaves = ttree.leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tloss_, metrics = TT.forward_train(tp, tb["tokens"], tb["targets"], tcfg,
                                       **_extras_kw(tb))
    grads = torch.autograd.grad(tloss_, leaves)
    np.testing.assert_allclose(tloss_.item(), float(jloss), rtol=1e-5)
    if tcfg.num_image_tokens:
        # the image positions carry no loss
        assert metrics["ntokens"].item() == B * (S - tcfg.num_image_tokens)
    paths = ttree.leaves_with_path(tp)
    for (path, _), g, w in zip(paths, grads, jax.tree.leaves(jgrads)):
        w = np.asarray(w, np.float32)
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (path, err, np.abs(w).max())


def test_kernel_wrappers_differentiate_like_their_plain_versions(rng):
    """On the CPU the autograd Functions of ``ops`` give the gradients of
    the plain versions, and run under ``inference_mode`` as well as under
    ``no_grad`` (the server's)."""
    def grads(fn, args, seed):
        args = [a.clone().requires_grad_() for a in args]
        outs = fn(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        gen = torch.Generator().manual_seed(seed)
        cot = [torch.randn(o.shape, generator=gen) for o in outs]
        return torch.autograd.grad(outs, args, cot)

    t = lambda *shape: torch.from_numpy(rng.normal(size=shape)
                                        .astype(np.float32))
    q, k, v = t(2, 12, 4, 16), t(2, 20, 2, 16), t(2, 20, 2, 16)
    for causal, window in ((True, 5), (False, None)):
        got = grads(lambda q, k, v: ops.flash_attention(
            q, k, v, causal=causal, window=window), (q, k, v), 1)
        want = grads(lambda q, k, v: fa.flash_attention_gqa_plain(
            q, k, v, causal=causal, window=window), (q, k, v), 1)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    x, Bm, Cm, s0 = t(2, 16, 3, 4), t(2, 16, 1, 8), t(2, 16, 1, 8), \
        t(2, 3, 4, 8)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (2, 16, 3))
                          .astype(np.float32))
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, (3,)).astype(np.float32))
    chunked = lambda x, dt, A, Bm, Cm, s0: ss.ssd_scan_plain(
        x.reshape(2, 2, 8, 3, 4), dt.reshape(2, 2, 8, 3), A,
        Bm.reshape(2, 2, 8, 8), Cm.reshape(2, 2, 8, 8), s0)
    got = grads(lambda *a: ops.ssd_scan_fused(*a[:5], chunk=8,
                                              init_state=a[5]),
                (x, dt, A, Bm, Cm, s0), 2)
    want = grads(lambda *a: tuple(o.reshape(o.shape) for o in chunked(*a)),
                 (x, dt, A, Bm, Cm, s0), 2)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    with torch.inference_mode():
        out = ops.flash_attention(q, k, v, causal=False)
        y, st = ops.ssd_scan_fused(x, dt, A, Bm, Cm, chunk=8)
    assert out.shape == q.shape and not out.requires_grad
    assert y.shape == x.shape and st.shape == (2, 3, 4, 8)


def test_loss_matches_jax_with_mask(rng):
    from repro.models import loss as jloss
    logits = rng.normal(size=(2, 6, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (2, 6)).astype(np.int32)
    mask = rng.random((2, 6)) > 0.4
    for m in (None, mask):
        want, wm = jloss.cross_entropy(
            jnp.asarray(logits), jnp.asarray(targets),
            None if m is None else jnp.asarray(m))
        got, gm = tloss.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
        assert gm["ntokens"].item() == float(wm["ntokens"])
        np.testing.assert_allclose(
            tloss.top1_accuracy(torch.from_numpy(logits),
                                torch.from_numpy(targets),
                                None if m is None else torch.from_numpy(m))
            .item(),
            float(jloss.top1_accuracy(jnp.asarray(logits),
                                      jnp.asarray(targets),
                                      None if m is None else jnp.asarray(m))),
            rtol=1e-6)


# ---------------------------------------------------------------------------
# Optimizers and the train step against the reference
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"a": rng.normal(size=(8, 8)).astype(np.float32),
            "b": [rng.normal(size=(8,)).astype(np.float32),
                  rng.normal(size=(2, 16, 8)).astype(np.float32)]}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_jax(rng, name):
    kw = dict(optimizer=name, learning_rate=0.05, warmup_steps=2,
              total_steps=10, weight_decay=0.1)
    jo, to = jopt.make_optimizer(JTrainConfig(**kw)), \
        make_optimizer(TrainConfig(**kw))
    params = _tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, params), \
        jax.tree.map(torch.from_numpy, params)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(3):
        g = _tree(rng)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(jax.tree.map(torch.from_numpy, g), ts, tp)
    _close_leaves(tp, jp, 1e-6, "params")
    _close_leaves(ts, js, 1e-6, "state")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_three_train_steps_match_jax(arch):
    """Three full steps (forward, backward, AdamW) of the port's
    ``make_train_step`` against the reference's step function called
    directly, on the same weights and batches, with the default
    ``TrainConfig`` (the one the reference's ``build_cell`` takes): the
    losses, gradient norms, AdamW's moments and the parameters.

    AdamW divides by sqrt(v), so where a gradient element is near zero
    its few-ulp difference between the packages moves that element's
    update by up to percents; the parameters stay within rtol 1e-5 while
    the learning rate is the default warmup's (3e-6 to 9e-6 over these
    steps), and the moments, linear in the gradients, at any rate."""
    jcfg, tcfg, jp, tp, _ = _setup(arch)
    jstep, jo = jsteps.make_train_step(jcfg, JTrainConfig())
    tstep, to = steps.make_train_step(tcfg, TrainConfig())
    jstep = jax.jit(jstep)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        batch = _setup(arch, seed=i + 1)[4]
        jp, js, jm = jstep(jp, js, _jbatch(batch))
        tp, ts, tm = tstep(tp, ts, _tbatch(batch))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-5)
    _close_leaves(ts["m"], js["m"], 1e-5, "AdamW m after three steps")
    _close_leaves(ts["v"], js["v"], 1e-5, "AdamW v after three steps")
    _close_leaves(tp, jp, 1e-5, "params after three steps")


@pytest.mark.parametrize("flags", [dict(bf16_weight_gather=True),
                                   dict(bf16_grads=True)])
def test_bf16_train_step_flags_match_jax(flags):
    """The compute-dtype weight copy (``bf16_weight_gather``) and the
    gradients taken with respect to it (``bf16_grads``), in the smoke
    config's bf16: one step's loss and gradient norm within the bf16
    budget of the parity tests (2e-2)."""
    jcfg = jreg.get_smoke_config("llama3-8b")
    tcfg = port_config(jcfg)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    batch = _setup("llama3-8b", seed=5)[4]
    jstep, jo = jsteps.make_train_step(jcfg, JTrainConfig(**flags))
    tstep, to = steps.make_train_step(tcfg, TrainConfig(**flags))
    _, _, jm = jax.jit(jstep)(jp, jo.init(jp), _jbatch(batch))
    new, _, tm = tstep(tp, to.init(tp), _tbatch(batch))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(tm[key].item(), float(jm[key]), rtol=2e-2)
    assert all(t.dtype == torch.float32 for t in ttree.leaves(new))


# ---------------------------------------------------------------------------
# The reference's TestOptimizers, on the port
# ---------------------------------------------------------------------------

def quad_params(rng):
    return {"a": torch.from_numpy(rng.normal(size=(8, 8))).float(),
            "b": torch.from_numpy(rng.normal(size=(8,))).float()}


class TestOptimizers:
    @pytest.mark.parametrize("name", ["adamw", "adafactor"])
    def test_minimises_quadratic(self, rng, name):
        tcfg = TrainConfig(optimizer=name, learning_rate=0.05,
                           warmup_steps=5, total_steps=200,
                           weight_decay=0.0)
        opt = make_optimizer(tcfg)
        params = quad_params(rng)
        state = opt.init(params)

        def loss(p):
            return sum(torch.sum((x - 1.0) ** 2) for x in ttree.leaves(p))

        l0 = float(loss(params))
        for _ in range(150):
            leaves = [x.clone().requires_grad_() for x in
                      ttree.leaves(params)]
            grads = torch.autograd.grad(
                loss(ttree.unflatten(params, leaves)), leaves)
            params, state = opt.update(ttree.unflatten(params, grads),
                                       state, params)
        assert float(loss(params)) < 0.05 * l0

    def test_adamw_state_shapes(self, rng):
        opt = adamw(TrainConfig())
        st = opt.init(quad_params(rng))
        assert st["m"]["a"].shape == (8, 8)
        assert st["v"]["b"].dtype == torch.float32

    def test_adafactor_factored_state_is_small(self):
        opt = adafactor(TrainConfig(optimizer="adafactor"))
        st = opt.init({"w": torch.zeros((64, 128))})
        assert sum(x.numel() for x in ttree.leaves(st["v"])) == 64 + 128

    def test_grad_clip_bounds_update(self, rng):
        tcfg = TrainConfig(grad_clip=1e-6, learning_rate=1.0,
                           warmup_steps=0, total_steps=10,
                           weight_decay=0.0)
        opt = adamw(tcfg)
        params = quad_params(rng)
        st = opt.init(params)
        huge = ttree.tree_map(lambda x: 1e6 * torch.ones_like(x), params)
        new_params, st2 = opt.update(huge, st, params)
        assert float(st2["gnorm"]) > 1.0
        delta = global_norm(ttree.tree_map(lambda a, b: a - b, new_params,
                                           params))
        assert float(delta) < 30.0

    def test_schedule_warmup_and_decay(self):
        lr = cosine_schedule(TrainConfig(learning_rate=1.0, warmup_steps=10,
                                         total_steps=100))
        step = lambda s: torch.tensor(s, dtype=torch.int32)
        assert float(lr(step(5))) == pytest.approx(0.5)
        assert float(lr(step(10))) == pytest.approx(1.0, rel=1e-3)
        assert float(lr(step(100))) == pytest.approx(0.0, abs=1e-6)


# ---------------------------------------------------------------------------
# The reference's TestData, on the port
# ---------------------------------------------------------------------------

class TestData:
    def test_deterministic_and_step_dependent(self):
        data = SyntheticLM(vocab_size=64, seq_len=16, global_batch=4,
                           device="cpu")
        b1, b2 = data.batch_at(3), data.batch_at(3)
        assert torch.equal(b1.tokens, b2.tokens)
        assert not torch.equal(b1.tokens, data.batch_at(4).tokens)

    def test_targets_are_shifted_tokens(self):
        b = SyntheticLM(vocab_size=64, seq_len=16, global_batch=2,
                        device="cpu").batch_at(0)
        assert torch.equal(b.tokens[:, 1:], b.targets[:, :-1])

    def test_bigram_structure_is_learnable(self):
        """Every transition comes from the chain table."""
        data = SyntheticLM(vocab_size=32, seq_len=32, global_batch=2,
                           branching=4, device="cpu")
        toks = data.batch_at(0).tokens.numpy()
        table = data.table.numpy()
        for bi in range(2):
            for t in range(31):
                assert toks[bi, t + 1] in table[toks[bi, t]]

    @pytest.mark.parametrize("seed", [0, 7])
    def test_bigram_table_bit_equal_to_reference(self, seed):
        want = np.asarray(JSyntheticLM(vocab_size=512, seq_len=8,
                                       global_batch=1, seed=seed).table)
        got = SyntheticLM(vocab_size=512, seq_len=8, global_batch=1,
                          seed=seed, device="cpu").table.numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    def test_batches_default_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        data = SyntheticLM(vocab_size=16, seq_len=4, global_batch=1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            data.batch_at(0)


# ---------------------------------------------------------------------------
# The reference's first three TestCheckpoint cases, on the port
# ---------------------------------------------------------------------------

class TestCheckpoint:
    def test_save_restore_roundtrip(self, rng, tmp_path):
        tree = {"params": {"w": torch.from_numpy(
                    rng.normal(size=(4, 4)).astype(np.float32))},
                "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
        store.save(str(tmp_path), 7, tree)
        assert store.latest_step(str(tmp_path)) == 7
        out = store.restore(str(tmp_path), 7, tree)
        assert torch.equal(out["params"]["w"], tree["params"]["w"])
        assert int(out["opt"]["step"]) == 7

    def test_atomic_overwrite_and_gc(self, tmp_path):
        ck = store.AsyncCheckpointer(str(tmp_path), keep=2)
        tree = {"w": torch.zeros((2,))}
        for s in (1, 2, 3, 4):
            ck.save(s, ttree.tree_map(lambda x: x + s, tree))
        ck.wait()
        steps_kept = sorted(int(d.split("_")[1]) for d in
                            os.listdir(tmp_path) if d.startswith("step_"))
        assert steps_kept == [3, 4]

    def test_shape_mismatch_raises(self, tmp_path):
        store.save(str(tmp_path), 1, {"w": torch.zeros((4,))})
        with pytest.raises(ValueError):
            store.restore(str(tmp_path), 1, {"w": torch.zeros((5,))})

    def test_reference_checkpoint_restores_into_the_port(self, rng,
                                                         tmp_path):
        """The same layout: a tree the reference saved (one ``.npy`` per
        leaf, named by its path) restores into the port's tree, bf16
        leaves too."""
        jtree = {"params": {"groups": [{"w": jnp.asarray(
                    rng.normal(size=(3, 4)), jnp.float32)}],
                    "embed": jnp.asarray(rng.normal(size=(5, 2)),
                                         jnp.float32)},
                 "opt": {"step": jnp.int32(3)}}
        jstore.save(str(tmp_path), 3, jtree)
        target = convert.to_torch(jax.tree.map(np.asarray, jtree), "cpu")
        target = ttree.tree_map(torch.zeros_like, target)
        out = store.restore(str(tmp_path), 3, target)
        for got, want in zip(ttree.leaves(out), jax.tree.leaves(jtree)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        bf = {"w": torch.randn(3, 2).to(torch.bfloat16)}
        store.save(str(tmp_path), 4, bf)
        assert torch.equal(store.restore(str(tmp_path), 4, bf)["w"],
                           bf["w"])


# ---------------------------------------------------------------------------
# The reference's TestTrainingLearns, on the port; the driver
# ---------------------------------------------------------------------------

def tiny_cfg(**kw):
    base = dict(name="tiny", family="dense", num_layers=2, d_model=64,
                d_ff=128, vocab_size=128, compute_dtype="float32",
                remat_policy="none", tie_embeddings=True,
                attention=AttentionConfig(num_heads=4, num_kv_heads=2,
                                          head_dim=16))
    base.update(kw)
    return ModelConfig(**base)


class TestTrainingLearns:
    def test_loss_decreases_on_bigram_chain(self):
        cfg = tiny_cfg(vocab_size=32)   # small table -> learns in ~100 steps
        tcfg = TrainConfig(learning_rate=5e-3, warmup_steps=5,
                           total_steps=100, weight_decay=0.0)
        out = train.train_loop(cfg, tcfg, batch=4, seq=64, steps=100,
                               log_every=20, device="cpu")
        first, last = out["losses"][0][1], out["losses"][-1][1]
        # vocab ceiling ln(32) ~ 3.47; chain entropy ln(8) ~ 2.08
        assert last < first - 0.3, (first, last)

    def test_checkpoint_resume_continues(self, tmp_path):
        cfg = tiny_cfg()
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2,
                           total_steps=20)
        train.train_loop(cfg, tcfg, batch=2, seq=32, steps=10,
                         ckpt_dir=str(tmp_path), ckpt_every=5, log_every=5,
                         device="cpu")
        out = train.train_loop(cfg, tcfg, batch=2, seq=32, steps=20,
                               ckpt_dir=str(tmp_path), resume=True,
                               log_every=5, device="cpu")
        assert out["losses"][0][0] > 10  # resumed past step 10


def test_resume_restores_the_saved_state(tmp_path):
    """A run of 6 steps equals a run of 3, checkpointed, resumed to 6."""
    cfg = tiny_cfg()
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=6)
    kw = dict(batch=2, seq=16, log_every=1, device="cpu")
    whole = train.train_loop(cfg, tcfg, steps=6, **kw)
    train.train_loop(cfg, tcfg, steps=3, ckpt_dir=str(tmp_path), **kw)
    resumed = train.train_loop(cfg, tcfg, steps=6, ckpt_dir=str(tmp_path),
                               resume=True, **kw)
    assert [s for s, _ in resumed["losses"]] == [4, 5, 6]
    for got, want in zip(ttree.leaves(resumed["params"]),
                         ttree.leaves(whole["params"])):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("field, value, points_to", [
    ("coded_dp", True, "launch.fault.coded_dp_grads"),
    ("layered_grad_planes", 2, "optim.layered_grads.layered_allreduce_tree")])
def test_multi_device_fields_raise(field, value, points_to):
    with pytest.raises(NotImplementedError, match=points_to):
        train.train_loop(tiny_cfg(), TrainConfig(**{field: value}), batch=1,
                         seq=8, steps=1, device="cpu")


@pytest.mark.parametrize("arch", ["llama3-8b-smoke", "mamba2-370m-smoke",
                                  "whisper-tiny-smoke", "internvl2-1b-smoke"])
def test_main_trains_smoke_arch_on_cpu(capsys, arch):
    assert train.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                       "--batch", "2", "--seq", "16"]) == 0
    assert "[train] loss" in capsys.readouterr().out


def test_prefill_and_serve_steps_match_the_model(rng):
    cfg = port_config(dataclasses.replace(
        jreg.get_smoke_config("whisper-tiny"), compute_dtype="float32"))
    params = TT.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)))
    batch = dict(TT.stub_extras(cfg, 2, "cpu"), tokens=toks[:, :8])
    last, caches = steps.make_prefill_step(cfg, 12)(params, batch)
    want, _ = TT.forward(params, toks, cfg,
                         audio_embeds=batch["audio_embeds"])
    logits, nxt, _ = steps.make_serve_step(cfg)(
        params, {"token": toks[:, 8:], "caches": caches, "pos": 8})
    torch.testing.assert_close(logits, want[:, -1], rtol=2e-3, atol=2e-3)
    assert torch.equal(nxt, logits.argmax(-1))
    assert last.shape == (2, cfg.vocab_size)


def test_zero_stub_inputs_overflow_at_depth_in_both_packages(rng):
    """ROADMAP R7: on the reference's zero patch embeddings, internvl2-1b's
    image positions stay zero through every layer and each RMS norm's
    backward multiplies the gradient there by rsqrt(1e-6): at 24 layers
    (smoke width, fp32) both packages' gradients overflow; on the seeded
    draws ``train_loop`` uses (``stub_extras(seed=...)``) they do not."""
    jcfg = dataclasses.replace(jreg.get_smoke_config("internvl2-1b"),
                               num_layers=24, compute_dtype="float32",
                               remat_policy="none")
    cfg = port_config(jcfg)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    toks = rng.integers(0, cfg.vocab_size, (2, S + 1)).astype(np.int32)
    grad_fn = steps.make_grad_fn(cfg, TrainConfig())
    zeros = TT.stub_extras(cfg, 2, "cpu")
    seeded = TT.stub_extras(cfg, 2, "cpu", seed=0)
    assert not zeros["extra_embeds"].any() and seeded["extra_embeds"].std() > 0.5
    norms = {}
    for name, extras in (("zeros", zeros), ("seeded", seeded)):
        batch = dict(extras, tokens=torch.from_numpy(toks[:, :-1]).long(),
                     targets=torch.from_numpy(toks[:, 1:]).long())
        norms[name] = global_norm(grad_fn(tp, batch)[2]).item()
        jgrads = jax.grad(lambda p: JT.forward_train(
            p, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]), jcfg,
            extra_embeds=jnp.asarray(extras["extra_embeds"].numpy()))[0])(jp)
        norms["jax_" + name] = float(jopt.global_norm(jgrads))
    assert not np.isfinite(norms["zeros"]) and not np.isfinite(
        norms["jax_zeros"]), norms
    assert np.isfinite(norms["seeded"]) and np.isfinite(norms["jax_seeded"])
    np.testing.assert_allclose(norms["seeded"], norms["jax_seeded"],
                               rtol=1e-4)


def test_ssd_gradients_stay_finite_where_the_decay_overflows(rng):
    """At mamba2's widths a chunk's decays span hundreds of nats: exp of
    the upper triangle's differences overflows, which a mask applied after
    the exp carries into the gradient as 0 * inf.  The port's scan masks
    first, as the reference's ``_segsum``; its gradients equal
    ``jax.grad`` of the reference's ``ssd_scan`` within 1e-3 of the
    largest value (the gradient of A sums terms whose decays span those
    hundreds of nats, in another order than the reference's: a few 1e-4
    in fp32)."""
    from repro.models import ssm as jssm
    B, Sq, H, P, N, chunk = 1, 128, 2, 4, 8, 64
    x = rng.normal(size=(B, Sq, H, P)).astype(np.float32)
    dt = rng.uniform(0.5, 2.0, size=(B, Sq, H)).astype(np.float32)
    A = -np.array([8.0, 16.0], np.float32)
    Bm = rng.normal(size=(B, Sq, 1, N)).astype(np.float32)
    Cm = rng.normal(size=(B, Sq, 1, N)).astype(np.float32)
    args = (x, dt, A, Bm, Cm)

    def jloss(*a):
        y, s = jssm.ssd_scan(*a, chunk)
        return jnp.sum(y) + jnp.sum(s)

    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, s = ops.ssd_scan_fused(*leaves, chunk=chunk)
    got = torch.autograd.grad(y.sum() + s.sum(), leaves)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert torch.isfinite(g).all() and np.isfinite(w).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max())


def test_sigterm_handler_saves_then_exits_and_is_put_back(tmp_path):
    """``install_sigterm_handler`` runs the final save, then exits with
    143; ``train_loop`` puts the previous handler back when it returns."""
    import signal
    before = signal.getsignal(signal.SIGTERM)
    saved = []
    previous = store.install_sigterm_handler(lambda: saved.append(1))
    try:
        with pytest.raises(SystemExit) as exit_info:
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        assert saved == [1] and exit_info.value.code == 143
    finally:
        signal.signal(signal.SIGTERM, previous)
    train.train_loop(tiny_cfg(), TrainConfig(), batch=1, seq=8, steps=1,
                     ckpt_dir=str(tmp_path), device="cpu")
    assert signal.getsignal(signal.SIGTERM) == before
    assert store.latest_step(str(tmp_path)) == 1
