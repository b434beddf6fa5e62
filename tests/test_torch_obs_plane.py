"""The port's stats plane (``obs/{digest,slo,metric_schema}.py``) and
``Telemetry.counter_value`` held against the JAX package's, each side fed
the same telemetry through its own registry:

- the digest algebra: ``registry_digest``, ``DigestSource`` deltas,
  ``merge``/``merge_all``/``merge_into`` and ``serialize`` give JAX's
  bytes; ``validate`` accepts and refuses the same digests;
- ``DigestRollup`` ingesting the same frames (duplicates, garbage and a
  stale source among them) gives JAX's snapshot, sources and stats, and
  ``SloEngine`` + ``build_status`` JAX's status JSON and report;
- ``metric_schema`` has JAX's names and types; ``hist_quantile`` and
  ``write_json_atomic`` agree.

Tolerance everywhere: none (exact bytes and values; timestamps are
passed in).
"""

import json

import pytest

import fedml_tpu.obs.digest as jdigest
import fedml_tpu.obs.metric_schema as jschema
import fedml_tpu.obs.slo as jslo
import fedml_tpu.obs.telemetry as jtelemetry
from fedml_tpu_torch.obs import digest, metric_schema, slo, telemetry


def _feed(tel, step):
    """The same telemetry feed on either package's registry."""
    tel.inc("comm.sent_bytes", 100.0 * (step + 1), msg_type="S2C_SYNC_MODEL")
    tel.inc("comm.recv_bytes", 37.5 + step, msg_type="C2S_SEND_MODEL")
    tel.inc("faults.observed", kind="stale_upload", msg_type="C2S_SEND_MODEL")
    if step % 2:
        tel.inc("faults.observed", kind="corrupt_upload", msg_type="C2S_SEND_MODEL")
        tel.inc("rounds.degraded")
    tel.gauge_set("comm.inflight", float(step % 3))
    for v in (0.003 * (step + 1), 0.25, 1.5 + step, 1e-5):
        tel.observe("span.decode_s", v)
    tel.observe("async.upload_staleness", float(step % 3))
    tel.event("round_close", round=step, participants=3)


def _pair():
    return telemetry.Telemetry(), jtelemetry.Telemetry()


def test_counter_value_matches_jax():
    t, j = _pair()
    for step in range(4):
        _feed(t, step)
        _feed(j, step)
        for name, labels in (("comm.sent_bytes", {"msg_type": "S2C_SYNC_MODEL"}),
                             ("faults.observed", {"kind": "corrupt_upload",
                                                  "msg_type": "C2S_SEND_MODEL"}),
                             ("rounds.degraded", {}), ("never.bumped", {})):
            assert t.counter_value(name, **labels) == j.counter_value(name, **labels)
    assert t.snapshot() == j.snapshot()


def test_registry_digest_and_source_deltas_match_jax():
    t, j = _pair()
    src, jsrc = (digest.DigestSource(4, nodes=[4, 5], telemetry=t),
                 jdigest.DigestSource(4, nodes=[4, 5], telemetry=j))
    for step in range(4):
        _feed(t, step)
        _feed(j, step)
        assert digest.serialize(src.next(t=10.0 + step)) == \
            jdigest.serialize(jsrc.next(t=10.0 + step))
    assert digest.serialize(digest.registry_digest(t, node=3, nodes=[1, 2], seq=5, t=99.0)) \
        == jdigest.serialize(jdigest.registry_digest(j, node=3, nodes=[1, 2], seq=5, t=99.0))


def _digests(mod, tel_mod):
    out = []
    for node in (1, 2, 3):
        tel = tel_mod.Telemetry()
        for step in range(node + 1):
            _feed(tel, step + node)
        out.append(mod.registry_digest(tel, node=node, seq=node, t=20.0 + node))
    return out


def test_merge_serialize_validate_match_jax():
    ds, jds = _digests(digest, telemetry), _digests(jdigest, jtelemetry)
    assert [digest.serialize(d) for d in ds] == [jdigest.serialize(d) for d in jds]
    assert digest.serialize(digest.merge(ds[0], ds[2])) == \
        jdigest.serialize(jdigest.merge(jds[0], jds[2]))
    assert digest.serialize(digest.merge_all(ds)) == jdigest.serialize(jdigest.merge_all(jds))
    acc, jacc = digest.empty_digest(), jdigest.empty_digest()
    for d, jd in zip(ds, jds):
        acc, jacc = digest.merge_into(acc, d), jdigest.merge_into(jacc, jd)
    acc, jacc = digest.merge(acc, digest.empty_digest()), jdigest.merge(jacc, jdigest.empty_digest())
    assert digest.serialize(acc) == jdigest.serialize(jacc)
    blob = digest.serialize(acc)
    assert digest.deserialize(blob) == jdigest.deserialize(blob)
    bad = [None, {}, {"v": 99}, {**ds[0], "counters": {"x": float("nan")}},
           {**ds[0], "hists": {"h": {"count": -1}}}, {**ds[0], "sources": "x"}, ds[1]]
    for b in bad:
        try:
            jdigest.validate(b)
        except Exception as e:  # noqa: BLE001 - the refusal's type is compared
            with pytest.raises(type(e)):
                digest.validate(b)
        else:
            digest.validate(b)


def _rollup_run(dmod, smod, tmod):
    rollup = dmod.DigestRollup()
    frames = _digests(dmod, tmod)
    for i, d in enumerate(frames):
        rollup.ingest(d, t=30.0 + i)
    rollup.ingest(frames[1], t=34.0)            # duplicate
    rollup.ingest({"garbage": True}, t=35.0)   # rejected
    rollup.ingest(b"not json", t=35.5)
    late = dmod.registry_digest(tmod.Telemetry(), node=9, seq=1, t=1.0)
    rollup.ingest(late, t=1.0)                 # a stream gone quiet
    tel = tmod.Telemetry()
    spec = smod.SloSpec(p99_round_wall_s=0.5, max_stale_uploads=3, max_corrupt_uploads=0,
                        min_participation=0.9, max_stale_streams=0, stale_after_s=5.0,
                        p99_upload_staleness=1.0)
    eng = smod.SloEngine(spec, telemetry=tel)
    eng._t_up = 0.0  # the coverage grace has passed
    for r, wall in enumerate((0.1, 0.9, 0.3)):
        eng.observe_round(r, wall_s=wall, round_bytes=1000.0 * (r + 1), participants=2 + r % 2,
                          target=3)
        rollup.ingest(dmod.registry_digest(tel, node=0, seq=r + 1, t=40.0 + r), t=40.0 + r)
        eng.evaluate(r, rollup.snapshot(), rollup.sources(now=41.0 + r, stale_after=5.0),
                     expected_nodes=[1, 2, 3, 4])
    status = smod.build_status(eng, rollup, round_idx=3, rounds_total=3,
                               expected_nodes=[1, 2, 3, 4], finished=True, now=50.0)
    report = eng.report(rollup.snapshot(), rollup.sources(now=50.0, stale_after=5.0),
                        expected_nodes=[1, 2, 3, 4], extra={"rounds_completed": 3})
    return rollup, status, report


def test_rollup_and_slo_status_match_jax(tmp_path):
    r, status, report = _rollup_run(digest, slo, telemetry)
    jr, jstatus, jreport = _rollup_run(jdigest, jslo, jtelemetry)
    assert digest.serialize(r.snapshot()) == jdigest.serialize(jr.snapshot())
    assert r.sources(now=50.0, stale_after=5.0) == jr.sources(now=50.0, stale_after=5.0)
    assert r.stats() == jr.stats() and r.covered_nodes() == jr.covered_nodes()
    assert status["slo"]["violations_total"] > 0
    dump = lambda o: json.dumps(_drop_wall(o), sort_keys=True)  # noqa: E731
    assert dump(status) == dump(jstatus)
    assert dump(report) == dump(jreport)
    slo.write_json_atomic(str(tmp_path / "a.json"), jstatus)
    jslo.write_json_atomic(str(tmp_path / "b.json"), jstatus)
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()


def _drop_wall(obj):
    """Drop the wall-clock stamps an engine takes itself (violation
    records' ``t``, the report's ``generated_t``), which differ between
    two runs by the time between them."""
    if isinstance(obj, dict):
        return {k: _drop_wall(v) for k, v in obj.items()
                if k not in ("t", "generated_t", "t_up")}
    if isinstance(obj, list):
        return [_drop_wall(v) for v in obj]
    return obj


@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_hist_quantile_matches_jax(q):
    t, j = _pair()
    for step in range(5):
        _feed(t, step)
        _feed(j, step)
    h, jh = t.snapshot()["hists"]["span.decode_s"], j.snapshot()["hists"]["span.decode_s"]
    assert slo.hist_quantile(h, q) == jslo.hist_quantile(jh, q)
    assert slo.hist_quantile(None, q) == jslo.hist_quantile(None, q)


def test_metric_schema_is_jaxs():
    for name in ("COUNTERS", "GAUGES", "HISTOGRAMS", "METRIC_PATTERNS", "EVENTS", "METRICS"):
        assert getattr(metric_schema, name) == getattr(jschema, name), name
    for name in list(jschema.METRICS) + ["span.decode_s", "comm.sent_bytes", "nope.x",
                                         "chaos.whatever", "jax.compiles"]:
        assert metric_schema.metric_type(name) == jschema.metric_type(name)
    assert digest.DIGEST_KEY == jdigest.DIGEST_KEY
    assert digest.DEFAULT_STALE_AFTER_S == jdigest.DEFAULT_STALE_AFTER_S
    assert slo.SloSpec().to_dict() == jslo.SloSpec().to_dict()
    spec = {"p99_round_wall_s": 2.0, "max_stale_streams": 1}
    assert slo.SloSpec.from_obj(spec) == slo.SloSpec(**spec)
    assert slo.SloSpec.from_obj(spec).to_dict() == jslo.SloSpec.from_obj(spec).to_dict()
