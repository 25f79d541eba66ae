"""The port's output layer on the CPU: counterparts of tests/test_io.py
(checkpoint and resume, CSV export and read-back, the csv stream, 'post'
and 'none' output, ChainReader), and parity with the JAX package: the same
arrays give byte-identical directories through both writers, each package
reads the other's directory exactly, and a tree gives the same checkpoint
key strings.  A csv run equals the nstate run of the same generator seed
bit for bit, and a resume from a reloaded checkpoint equals the live one."""

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import klara_tpu as jkt
import klara_tpu.io as jio
from klara_tpu.io.stream import StreamingWriter as JaxStreamingWriter

import klara_tpu_torch as kt
from klara_tpu_torch import distributions as td
from klara_tpu_torch.io import (
    ChainReader,
    load_checkpoint,
    read_chain,
    read_chain_csv,
    save_checkpoint,
    write_chain_csv,
)
from klara_tpu_torch.io.stream import StreamingWriter


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _target():
    return kt.Target(logdensity_fn=lambda x: -0.5 * torch.square(x).sum(-1), dim=2)


def _small_chain(n_chains=4, destination="nstate", **kwargs):
    job = kt.MCJob(_target(), kt.MALA(driftstep=1.0), kt.MCRange(n_steps=200, burnin=50),
                   n_chains=n_chains, destination=destination, device="cpu", **kwargs)
    return job, job.run(_gen(0), torch.zeros(2))


def _mh_job(**kw):
    base = dict(target=_target(), sampler=kt.MH(sigma=0.5),
                mcrange=kt.MCRange(n_steps=400, burnin=100), n_chains=4,
                monitor=("value",), diagnostics=("accept",), device="cpu")
    base.update(kw)
    return kt.MCJob(**base)


def _leaves_equal(a, b):
    from klara_tpu_torch.io.checkpoint import _leaf_paths

    pa, pb = _leaf_paths(a), _leaf_paths(b)
    assert [k for k, _ in pa] == [k for k, _ in pb]
    for (k, x), (_, y) in zip(pa, pb):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), k
        else:
            assert x.dtype == y.dtype and x.device == y.device, k
            assert torch.equal(x, y), k


# ----------------------------------------------- counterparts of test_io.py
def test_checkpoint_roundtrip_full_state(tmp_path):
    """Every leaf of the sampler state and the generator's state survive."""
    _, chain = _small_chain()
    path = str(tmp_path / "ckpt.npz")
    gen = _gen(42)
    tree = {"state": chain.final_state, "generator": gen}
    save_checkpoint(path, tree)
    restored = load_checkpoint(path, like={"state": chain.final_state,
                                           "generator": torch.Generator()})
    _leaves_equal(tree, restored)
    assert type(restored["state"]) is type(chain.final_state)
    assert type(restored["state"].tune.extra) is type(chain.final_state.tune.extra)
    assert torch.equal(torch.rand(5, generator=restored["generator"]),
                       torch.rand(5, generator=gen))


def test_checkpoint_resume_continues_sampling(tmp_path):
    """resume from a restored state keeps the adapted step and samples the
    target."""
    job, chain = _small_chain()
    path = str(tmp_path / "state.npz")
    save_checkpoint(path, chain.final_state)
    restored = load_checkpoint(path, like=chain.final_state)
    chain2 = job.resume(_gen(1), dataclasses.replace(chain, final_state=restored))
    assert chain2.value.shape == chain.value.shape
    assert abs(float(chain2.flat("value").mean())) < 0.3


def test_csv_write_read_roundtrip(tmp_path):
    _, chain = _small_chain()
    d = str(tmp_path / "out")
    written = write_chain_csv(chain, d)
    assert set(written) == {"value", "logtarget", "accept"}
    back = read_chain_csv(d)
    np.testing.assert_array_equal(back["value"].astype(np.float32), chain.value.numpy())
    np.testing.assert_array_equal(back["logtarget"].astype(np.float32),
                                  chain["logtarget"].numpy())
    np.testing.assert_array_equal(back["accept"], chain["accept"].numpy())


def test_streaming_destination(tmp_path):
    """destination='csv': the draws stream to files during the run and the
    returned chain holds no trace."""
    d = str(tmp_path / "stream")
    _, chain = _small_chain(destination="csv", filepath=d)
    assert chain.samples == {} and chain.diagnostics == {}
    assert {"value.csv", "logtarget.csv"} <= set(os.listdir(d))
    rows = np.loadtxt(os.path.join(d, "value.csv"), delimiter=",")
    n_post = 200 - 50
    assert rows.shape == (n_post, 4 * 2)
    lts = np.loadtxt(os.path.join(d, "logtarget.csv"), delimiter=",")
    vals = rows.reshape(n_post, 4, 2)
    np.testing.assert_allclose(lts, -0.5 * np.sum(vals**2, axis=-1), rtol=1e-4)


def test_destination_none():
    _, chain = _small_chain(destination="none")
    assert chain.samples == {} and chain.diagnostics == {}
    assert chain.final_state.position.shape == (4, 2)


def test_read_chain_typed_roundtrip(tmp_path):
    """write_chain_csv then read_chain gives a Chain the stats layer takes
    as it takes the trace."""
    job = _mh_job(mcrange=kt.MCRange(n_steps=500, burnin=100), monitor=("value", "logtarget"))
    chain = job.run(_gen(11), torch.zeros(2))
    d = str(tmp_path / "trip")
    write_chain_csv(chain, d)
    back = read_chain(d, device="cpu")
    assert set(back.samples) == {"value", "logtarget"}
    assert set(back.diagnostics) == {"accept"}
    assert isinstance(back, kt.Chain) and back.value.dtype == torch.float64
    assert torch.equal(back.value.float(), chain.value)
    torch.testing.assert_close(kt.stats.mean(back).float(), kt.stats.mean(chain),
                               rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(kt.stats.ess(back).float(), kt.stats.ess(chain), rtol=1e-4,
                               atol=1e-3)
    assert abs(float(kt.stats.acceptance(back)) - float(kt.stats.acceptance(chain))) < 1e-6


def test_streamed_csv_reads_back_as_chain(tmp_path):
    d = str(tmp_path / "stream")
    _mh_job(destination="csv", filepath=d).run(_gen(12), torch.zeros(2))
    back = read_chain(d, device="cpu")
    assert back.samples["value"].shape == (300, 4, 2)
    assert "accept" in back.diagnostics
    ess = kt.stats.ess(back)
    assert bool(torch.isfinite(ess).all()) and bool((ess > 0).all())


def test_chain_reader_mark_reset(tmp_path):
    job = _mh_job(mcrange=kt.MCRange(n_steps=300, burnin=100), n_chains=2)
    chain = job.run(_gen(13), torch.zeros(2))
    d = str(tmp_path / "reader")
    write_chain_csv(chain, d)
    with ChainReader(d, fields=["value"]) as r:
        first = r.read_new()["value"]
        assert first.shape[0] == 200
        assert r.read_new()["value"].shape[0] == 0
        r.reset()
        np.testing.assert_array_equal(first, r.read_new()["value"])
        r.reset()
        r.mark()
        r.read_new()
        r.reset()
        assert r.read_new()["value"].shape[0] == 200


def test_chain_reader_partial_trailing_line(tmp_path):
    """read_new consumes complete lines only and takes the rest of a partly
    written row once it is complete."""
    d = tmp_path / "partial"
    d.mkdir()
    f = d / "value.csv"
    f.write_text("1.0,2.0\n3.0,4.0\n5.0,6")
    with ChainReader(str(d), fields=["value"]) as r:
        np.testing.assert_array_equal(r.read_new()["value"], [[1.0, 2.0], [3.0, 4.0]])
        assert r.read_new()["value"].shape == (0, 2)
        with open(f, "a") as h:
            h.write(".0\n7.0,8.0\n")
        np.testing.assert_array_equal(r.read_new()["value"], [[5.0, 6.0], [7.0, 8.0]])


def test_read_chain_csv_stale_shape_sidecar(tmp_path):
    """The data decides the draws axis, the sidecar the event shape."""
    d = tmp_path / "stale"
    d.mkdir()
    rows = np.arange(10.0).reshape(5, 2)
    np.savetxt(d / "value.csv", rows, delimiter=",", fmt="%.9g")
    (d / "value.shape").write_text("3,1,2")
    out = read_chain_csv(str(d))
    assert out["value"].shape == (5, 1, 2)
    np.testing.assert_array_equal(out["value"].reshape(5, 2), rows)


def test_streaming_writer_crash_leaves_readable_output(tmp_path):
    """The manifest and sidecars are written at the first row, so a writer
    never closed leaves a directory that reads back."""
    d = str(tmp_path / "crashed")
    w = StreamingWriter(d, flush=True, sample_fields={"value"})
    for i in range(4):
        w.append(True, {"value": torch.full((2, 3), float(i)), "accept": torch.ones(2)})
    chain = read_chain(d, device="cpu")
    assert chain.samples["value"].shape == (4, 2, 3)
    assert chain.diagnostics["accept"].shape == (4, 2)
    assert chain.samples["value"][:, 0, 0].tolist() == [0.0, 1.0, 2.0, 3.0]
    w.close()


def test_sample_prior_event_shapes():
    t_mv = kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum(-1), dim=3,
                     prior=td.MvNormal(torch.zeros(3), torch.eye(3)))
    assert t_mv.sample_prior(_gen(), 4).shape == (4, 3)
    t_sc = kt.Target(logdensity_fn=lambda x: -0.5 * (x * x).sum(-1), dim=4,
                     prior=td.Normal(0.0, 1.0))
    assert t_sc.sample_prior(_gen(), 4).shape == (4, 4)


def test_chunked_streaming_matches_device_trace(tmp_path):
    """A stream_chunk that does not divide n_steps: the streamed rows and the
    final state equal the nstate run of the same seed bit for bit."""
    kw = dict(mcrange=kt.MCRange(n_steps=333, burnin=100, thinning=2))
    ref = _mh_job(**kw).run(_gen(5), torch.zeros(2))
    d = str(tmp_path / "chunked")
    job = _mh_job(**kw, destination="csv", filepath=d, stream_chunk=50)
    chain = job.run(_gen(5), torch.zeros(2))
    back = read_chain(d, device="cpu")
    assert back.value.shape == ref.value.shape == (117, 4, 2)
    assert torch.equal(back.value.float(), ref.value)
    assert torch.equal(back["accept"].bool(), ref["accept"])
    _leaves_equal(chain.final_state, ref.final_state)
    assert job._ring.rows == 50 and job._ring.bufs["value"].device.type == "cpu"


def test_csv_post_mode_buffered_export(tmp_path):
    """stream_mode='post' keeps the device trace, returns it, and appends it
    to the files after the run; resume appends a second segment."""
    d = str(tmp_path / "post")
    job = _mh_job(mcrange=kt.MCRange(n_steps=300, burnin=100), destination="csv",
                  filepath=d, stream_mode="post")
    chain = job.run(_gen(9), torch.zeros(2))
    assert chain.samples["value"].shape == (200, 4, 2)
    assert torch.equal(read_chain(d, device="cpu").value.float(), chain.value)
    second = job.resume(_gen(10), chain)
    back = read_chain(d, device="cpu")
    assert back.value.shape == (400, 4, 2)
    assert torch.equal(back.value[200:].float(), second.value)


@pytest.mark.parametrize("case", ["stream_mode", "destination", "filepath"])
def test_output_validation_errors(case):
    kw = {"stream_mode": dict(destination="csv", filepath="out", stream_mode="bogus"),
          "destination": dict(destination="bogus"),
          "filepath": dict(destination="csv")}[case]
    with pytest.raises(ValueError, match=case):
        kt.MCJob(_target(), kt.MH(), kt.MCRange(n_steps=10), device="cpu", **kw)


# ------------------------------------------------ parity with the JAX package
def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((7, 3, 2)).astype(np.float32) * np.float32(10.0) ** rng.integers(
        -30, 30, (7, 3, 2)).astype(np.float32)
    value.flat[:6] = [np.nan, np.inf, -np.inf, -0.0, 1e-40, 3.4e38]
    return {
        "value": value,
        "logtarget": rng.standard_normal((7, 3)).astype(np.float32),
        "accept": rng.random((7, 3)) < 0.5,
        "nleaps": rng.integers(0, 100, (7, 3)).astype(np.int32),
    }


def _dir_bytes(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def test_write_chain_csv_byte_identical_to_jax(tmp_path):
    a = _arrays()
    samples, diags = ("value", "logtarget"), ("accept", "nleaps")
    jchain = jkt.Chain(samples={k: a[k] for k in samples},
                       diagnostics={k: a[k] for k in diags}, final_state=None)
    tchain = kt.Chain(samples={k: torch.from_numpy(a[k]) for k in samples},
                      diagnostics={k: torch.from_numpy(a[k]) for k in diags})
    jio.write_chain_csv(jchain, str(tmp_path / "jax"))
    write_chain_csv(tchain, str(tmp_path / "port"))
    jb, tb = _dir_bytes(tmp_path / "jax"), _dir_bytes(tmp_path / "port")
    assert len(jb) == 9 and jb == tb


def test_streaming_writer_byte_identical_to_jax(tmp_path):
    """Two blocks (the first part-filled), one single-row append and a bf16
    field through both packages' StreamingWriter."""
    a = _arrays(1)
    bf = torch.from_numpy(np.random.default_rng(2).standard_normal((7, 3)).astype(np.float32))
    bf = bf.to(torch.bfloat16)
    a_j = {**a, "step": np.asarray(jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16))}
    a_t = {**{k: torch.from_numpy(v) for k, v in a.items()}, "step": bf}
    for W, arrs, name in ((JaxStreamingWriter, a_j, "jax"), (StreamingWriter, a_t, "port")):
        w = W(str(tmp_path / name), sample_fields={"value", "logtarget"})
        w.append_block(3, {k: v[:5] for k, v in arrs.items()})
        w.append(True, {k: v[3] for k, v in arrs.items()})
        w.append(False, {k: v[4] for k, v in arrs.items()})
        w.append_block(3, {k: v[4:] for k, v in arrs.items()})
        w.close()
    jb, tb = _dir_bytes(tmp_path / "jax"), _dir_bytes(tmp_path / "port")
    assert len(jb) == 11 and jb == tb
    back = read_chain(str(tmp_path / "port"), device="cpu")
    assert torch.equal(back["step"].to(torch.bfloat16), bf)


def test_each_package_reads_the_others_directory(tmp_path):
    a = _arrays(3)
    jio.write_chain_csv(jkt.Chain(samples={"value": a["value"]},
                                  diagnostics={"accept": a["accept"]}, final_state=None),
                        str(tmp_path / "jax"))
    write_chain_csv(kt.Chain(samples={"value": torch.from_numpy(a["value"])},
                             diagnostics={"accept": torch.from_numpy(a["accept"])}),
                    str(tmp_path / "port"))
    for d in ("jax", "port"):
        j = jio.read_chain(str(tmp_path / d))
        t = read_chain(str(tmp_path / d), device="cpu")
        for k in ("value", "accept"):
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
        np.testing.assert_array_equal(t.value.numpy().astype(np.float32), a["value"])


class _Pair(NamedTuple):
    position: object
    tune: object


def test_checkpoint_key_strings_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    arr = [rng.standard_normal(s).astype(np.float32) for s in ((3, 2), (3,), (2,), (4,))]
    jtree = {"state": _Pair(arr[0], _Pair(arr[1], ())), "n": [arr[2], {"b": arr[3]}],
             "none": None}
    ttree = {"state": _Pair(*map(torch.from_numpy, arr[:1]), _Pair(torch.from_numpy(arr[1]), ())),
             "n": [torch.from_numpy(arr[2]), {"b": torch.from_numpy(arr[3])}], "none": None}
    jio.save_checkpoint(str(tmp_path / "jax.npz"), jtree)
    save_checkpoint(str(tmp_path / "port.npz"), ttree)
    j, t = jio.load_checkpoint(str(tmp_path / "jax.npz")), load_checkpoint(str(tmp_path / "port.npz"))
    assert sorted(t) == sorted(j) == ["['n'][0]", "['n'][1]['b']", "['state'].position",
                                      "['state'].tune.position"]
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])
    back = load_checkpoint(str(tmp_path / "jax.npz"), like=ttree)
    assert back["none"] is None and torch.equal(back["n"][1]["b"], ttree["n"][1]["b"])


def test_checkpoint_bf16_leaf_roundtrip(tmp_path):
    x = torch.randn(5, 3, generator=_gen(6)).to(torch.bfloat16)
    save_checkpoint(str(tmp_path / "bf.npz"), {"x": x, "k": 3, "f": 0.5})
    assert load_checkpoint(str(tmp_path / "bf.npz"))["['x']"].dtype == np.int16
    back = load_checkpoint(str(tmp_path / "bf.npz"), like={"x": x, "k": 0, "f": 0.0})
    assert back["x"].dtype == torch.bfloat16 and torch.equal(back["x"], x)
    assert back["k"] == 3 and back["f"] == 0.5


def test_resume_from_reloaded_checkpoint_equals_live_resume(tmp_path):
    """Save state and generator after a run; the resume from the reloaded
    file equals the resume from the live state and generator, bit for bit,
    tuner state included."""
    job = kt.MCJob(_target(), kt.MALA(), kt.MCRange(n_steps=120, burnin=40), n_chains=8,
                   tuner=kt.DualAveragingTuner(0.574, 40), pooled_tuning=True, step_size=0.5,
                   device="cpu")
    gen = _gen(21)
    chain = job.run(gen, torch.zeros(2))
    path = str(tmp_path / "run.npz")
    save_checkpoint(path, {"state": chain.final_state, "generator": gen})
    live = job.resume(gen, chain)
    tree = load_checkpoint(path, like={"state": chain.final_state, "generator": torch.Generator()})
    _leaves_equal(tree["state"].tune, chain.final_state.tune)
    again = job.resume(tree["generator"], dataclasses.replace(chain, final_state=tree["state"]))
    for k in ("value", "logtarget", "accept"):
        assert torch.equal(live[k], again[k])
    _leaves_equal(live.final_state, again.final_state)
