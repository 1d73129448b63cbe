"""The port's entry points (tfservingcache_tpu_torch/cli.py ``export``,
``repack``, ``warm``; config.py ``load_config``'s ``./config.yaml`` and
``TPUSC_*`` overrides) against the JAX package's, on the CPU.

``main(argv)`` runs in-process with every file under ``tmp_path``
(``monkeypatch.chdir``), one subprocess with a timeout; the root logger's
handlers and level, which ``main`` sets from the config, are put back after
each test. The reference's ``warm`` gets a compile cache under ``tmp_path``,
and JAX's process-wide cache settings are restored after it (as
tests/test_runtime.py does). Artifacts: the reference's t5 TINY_CONFIG and a
t5 at vocab 1024 / d_ff 1024 (its embedding and feed-forward weights reach
the int8 floor of 65536 elements), and a TINY transformer_lm (max_seq 64:
``warm`` clamps its 128/32 defaults).
"""

import dataclasses
import json
import logging
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from tfservingcache_tpu import cli as jcli
from tfservingcache_tpu import config as jconfig
from tfservingcache_tpu.models import registry as jreg
from tfservingcache_tpu.models.t5 import TINY_CONFIG as T5_TINY
from tfservingcache_tpu_torch import cli
from tfservingcache_tpu_torch import config as tconfig
from tfservingcache_tpu_torch.models import registry as treg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T5_INT8 = dict(T5_TINY, vocab_size=1024, d_ff=1024)
LM_TINY = {"vocab_size": 64, "d_model": 32, "n_layers": 1, "n_heads": 2, "n_kv_heads": 1,
           "d_ff": 64, "max_seq": 64, "dtype": "float32"}


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """cwd in ``tmp_path``, no ``TPUSC_*`` variable from outside, and the
    root logger as it was."""
    monkeypatch.chdir(tmp_path)
    for key in [k for k in os.environ if k.startswith("TPUSC_")]:
        monkeypatch.delenv(key)
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    try:
        yield
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)


def _leaves(cfg, prefix: str = "") -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_leaves(v, f"{prefix}{f.name}."))
        else:
            out[f"{prefix}{f.name}"] = v
    return out


_PORT_FIELDS = _leaves(tconfig.Config())
_REF_FIELDS = _leaves(jconfig.Config())
SHARED = sorted(k for k in _PORT_FIELDS if k in _REF_FIELDS
                and not isinstance(_PORT_FIELDS[k], dict))


# the card's default resident budget (an H100 holds 80 GB) against a TPU's
DEFAULTS_DIFFER = {k for k in SHARED if _PORT_FIELDS[k] != _REF_FIELDS[k]}
SAME_DEFAULT = [k for k in SHARED if k not in DEFAULTS_DIFFER]


def _env_key(field: str) -> str:
    return "TPUSC_" + field.replace(".", "_").upper()


def _env_value(default) -> str:
    """A string the field's type takes, unlike its default."""
    if isinstance(default, bool):
        return "off" if default else "On"
    if isinstance(default, int):
        return str(default + 3)
    if isinstance(default, float):
        return str(default + 0.25)
    if isinstance(default, (list, tuple)):
        return "a:1:2,,b:3:4"
    return "/x/" + str(default).strip("/")


def _get(cfg, field: str):
    for part in field.split("."):
        cfg = getattr(cfg, part)
    return cfg


# -- config: TPUSC_* overrides --------------------------------------------------

def test_every_shared_field_is_overridable():
    assert len(SHARED) >= 80 and "serving.device" not in SHARED
    assert DEFAULTS_DIFFER == {"serving.hbm_capacity_bytes"}
    assert "cache_node.rest_port" in SHARED and "observability.flight_dir" in SHARED


@pytest.mark.parametrize("field", SHARED)
def test_an_env_override_gives_the_references_value(monkeypatch, field):
    """One ``TPUSC_<SECTION>_<FIELD>`` variable: both packages'
    ``load_config`` coerce it to the same value of the same type (a bool
    word, an int, a float, a comma list or a string), and it changes the
    default."""
    value = _env_value(_PORT_FIELDS[field])
    monkeypatch.setenv(_env_key(field), value)
    got, want = _get(tconfig.load_config(), field), _get(jconfig.load_config(), field)
    assert got == want and type(got) is type(want)
    assert got != _PORT_FIELDS[field]
    assert _get(tconfig.load_config(env=False), field) == _PORT_FIELDS[field]


def test_overrides_together_agree_on_every_shared_field(monkeypatch):
    """An int, a float, a bool word, a string and nested sections at once:
    every field the two configs share is equal, not only the overridden."""
    env = {"TPUSC_SERVING_MAX_CONCURRENT_MODELS": "3", "TPUSC_SERVING_LOAD_TIMEOUT_S": "7.5",
           "TPUSC_SERVING_COLD_LOAD_PIPELINE": "FALSE", "TPUSC_LOGGING_FMT": "json",
           "TPUSC_CACHE_NODE_REST_PORT": "0", "TPUSC_CACHE_NODE_GRPC_PORT": "0",
           "TPUSC_CLUSTER_PEER_FETCH": "no", "TPUSC_DISCOVERY_NODES": "h:1:2,h:3:4",
           "TPUSC_SERVING_HBM_CAPACITY_BYTES": "1024"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = _leaves(tconfig.load_config()), _leaves(jconfig.load_config())
    assert {k: got[k] for k in SHARED} == {k: want[k] for k in SHARED}
    assert got["serving.max_concurrent_models"] == 3 and got["serving.load_timeout_s"] == 7.5
    assert got["serving.cold_load_pipeline"] is False and got["cluster.peer_fetch"] is False
    assert got["cache_node.rest_port"] == 0 and got["discovery.nodes"] == ["h:1:2", "h:3:4"]


@pytest.mark.parametrize("key,value", [("TPUSC_SERVING_MAX_CONCURRENT_MODELS", "many"),
                                       ("TPUSC_SERVING_LOAD_TIMEOUT_S", "soon"),
                                       ("TPUSC_CACHE_NODE_REST_PORT", "80.5")])
def test_a_bad_value_raises_naming_the_variable(monkeypatch, key, value):
    monkeypatch.setenv(key, value)
    with pytest.raises(ValueError) as want:
        jconfig.load_config()
    with pytest.raises(ValueError) as got:
        tconfig.load_config()
    assert str(got.value) == str(want.value) and key in str(got.value)


def test_the_port_only_device_field_is_overridable(monkeypatch):
    monkeypatch.setenv("TPUSC_SERVING_DEVICE", "cpu")
    assert tconfig.load_config().serving.device == "cpu"


def test_version_labels_take_a_json_object(monkeypatch):
    """A dict field takes a JSON object (the reference stores the raw string,
    which no label lookup can use); anything else raises."""
    monkeypatch.setenv("TPUSC_SERVING_VERSION_LABELS", '{"m": {"stable": 2}}')
    assert tconfig.load_config().serving.version_labels == {"m": {"stable": 2}}
    assert jconfig.load_config().serving.version_labels == '{"m": {"stable": 2}}'
    monkeypatch.setenv("TPUSC_SERVING_VERSION_LABELS", "[1]")
    with pytest.raises(ValueError, match="TPUSC_SERVING_VERSION_LABELS"):
        tconfig.load_config()


def test_config_from_dict_reads_no_environment(monkeypatch):
    monkeypatch.setenv("TPUSC_SERVING_MAX_CONCURRENT_MODELS", "3")
    assert tconfig.config_from_dict({}).serving.max_concurrent_models == 16


# -- config: files ---------------------------------------------------------------

def test_the_implicit_config_yaml_is_read_and_env_beats_it(tmp_path, monkeypatch):
    (tmp_path / "config.yaml").write_text(
        "serving:\n  max_concurrent_models: 5\n  batch_max_size: 9\n"
        "cache_node:\n  rest_port: 0\nlogging:\n  level: debug\n")
    monkeypatch.setenv("TPUSC_SERVING_BATCH_MAX_SIZE", "11")
    got, want = _leaves(tconfig.load_config()), _leaves(jconfig.load_config())
    assert {k: got[k] for k in SAME_DEFAULT} == {k: want[k] for k in SAME_DEFAULT}
    assert got["serving.max_concurrent_models"] == 5 and got["serving.batch_max_size"] == 11
    assert got["cache_node.rest_port"] == 0 and got["logging.level"] == "debug"
    # an explicit path wins over the implicit file
    (tmp_path / "other.json").write_text(json.dumps({"serving": {"max_concurrent_models": 2}}))
    assert tconfig.load_config("other.json").serving.max_concurrent_models == 2


def test_no_file_gives_the_defaults(monkeypatch):
    assert tconfig.load_config() == tconfig.Config()
    assert tconfig.load_config("") == tconfig.Config()


def test_a_missing_explicit_path_raises(tmp_path):
    """Deviation 13: the reference serves its defaults when ``--config``
    names no file; the port raises, so a mistyped path cannot start a node
    on the default ports."""
    missing = str(tmp_path / "nope.yaml")
    assert jconfig.load_config(missing) == jconfig.Config()
    with pytest.raises(FileNotFoundError):
        tconfig.load_config(missing)
    with pytest.raises(FileNotFoundError):
        cli.main(["serve", "--config", missing])
    with pytest.raises(FileNotFoundError):
        cli.main(["--config", missing, "serve"])


# -- export --------------------------------------------------------------------

def _read(path: str, name: str) -> bytes:
    with open(os.path.join(path, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_export_writes_the_references_layout(tmp_path, monkeypatch, capsys, quantize):
    """``export t5 --config-json`` on the CPU (``TPUSC_SERVING_DEVICE``)
    prints the artifact's path; its ``model.json`` is the JAX package's
    export of the same config byte for byte (the manifest depends on shapes
    only), and the JAX package loads its leaves. The weights themselves
    differ: torch's generator is not threefry."""
    monkeypatch.setenv("TPUSC_SERVING_DEVICE", "cpu")
    argv = ["export", "t5", str(tmp_path / "port"), "--name", "t5c", "--version", "3",
            "--config-json", json.dumps(T5_INT8), "--seed", "5"]
    if quantize:
        argv += ["--quantize", quantize]
    assert cli.main(argv) == 0
    path = capsys.readouterr().out.strip()
    assert path == str(tmp_path / "port" / "t5c" / "3")
    want = jreg.export_artifact("t5", str(tmp_path / "ref"), name="t5c", version=3,
                                config=T5_INT8, seed=5, quantize=quantize)
    assert _read(path, "model.json") == _read(want, "model.json")
    assert len(_read(path, "params.bin")) == len(_read(want, "params.bin"))
    jmodel, jparams = jreg.load_artifact(path)
    tmodel, tparams = treg.load_artifact(path)
    assert jmodel.family == tmodel.family == "t5"
    jflat = dict(treg.flatten_params(jparams))
    for name, leaf in treg.flatten_params(tparams):
        np.testing.assert_array_equal(np.asarray(jflat[name], np.float32), leaf.float().numpy())


def test_export_reads_its_device_from_the_config_file(tmp_path, capsys):
    (tmp_path / "cpu.json").write_text(json.dumps({"serving": {"device": "cpu"}}))
    assert cli.main(["--config", "cpu.json", "export", "half_plus_two", "store"]) == 0
    assert capsys.readouterr().out.strip() == os.path.join("store", "half_plus_two", "1")


def test_export_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """``serving.device`` defaults to "cuda": on a machine without a card the
    export raises instead of quietly initializing on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default export runs there")
    with pytest.raises(RuntimeError):
        cli.main(["export", "half_plus_two", str(tmp_path / "store")])
    assert not (tmp_path / "store" / "half_plus_two" / "1" / "model.json").exists()


@pytest.mark.parametrize("bad", ["[1, 2]", "", "{not json", "7"])
def test_config_json_that_is_not_an_object_exits_2(monkeypatch, bad):
    monkeypatch.setenv("TPUSC_SERVING_DEVICE", "cpu")
    monkeypatch.setenv("TPUSC_SERVING_PLATFORM", "cpu")
    argv = ["export", "t5", "store", "--config-json", bad]
    assert cli.main(argv) == jcli.main(argv) == 2
    assert not os.path.exists("store")


def test_export_in_a_subprocess(tmp_path):
    """``python -m tfservingcache_tpu_torch.cli export`` as a user runs it."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(TPUSC_SERVING_DEVICE="cpu", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "tfservingcache_tpu_torch.cli", "export", "t5",
                        str(tmp_path / "store"), "--name", "sub", "--config-json",
                        json.dumps(T5_TINY)], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(tmp_path / "store" / "sub" / "1")
    assert treg.load_artifact(r.stdout.strip())[0].config == treg.build("t5", T5_TINY).config


# -- repack --------------------------------------------------------------------

@pytest.mark.parametrize("family,config,quantize", [
    ("t5", T5_INT8, "int8"), ("t5", T5_INT8, None), ("t5", dict(T5_TINY, dtype="float32"), None),
    ("transformer_lm", dict(LM_TINY, d_ff=2048, dtype="bfloat16"), "int8")],
    ids=["t5_int8", "t5_bf16", "t5_f32", "lm_int8"])
def test_repack_is_the_references_byte_for_byte(tmp_path, monkeypatch, capsys, family, config,
                                                quantize):
    """``repack`` of a JAX-written artifact writes the JAX package's
    ``repack`` of it byte for byte (int8 leaves carried, never requantized);
    a plain artifact repacks to its own bytes, and a second repack of an
    int8 one to the first's."""
    monkeypatch.setenv("TPUSC_SERVING_PLATFORM", "cpu")
    src = jreg.export_artifact(family, str(tmp_path / "src"), name="m", config=config, seed=9,
                               quantize=quantize)
    assert cli.main(["repack", src, str(tmp_path / "port")]) == 0
    assert jcli.main(["repack", src, str(tmp_path / "ref")]) == 0
    out = capsys.readouterr().out.split()
    assert out == [str(tmp_path / "port"), str(tmp_path / "ref")]
    for name in ("params.bin", "model.json"):
        assert _read(out[0], name) == _read(out[1], name), name
    assert json.loads(_read(out[0], "model.json"))["quantize"] == quantize
    if quantize is None:
        assert _read(out[0], "params.bin") == _read(src, "params.bin")
        assert _read(out[0], "model.json") == _read(src, "model.json")
    assert cli.main(["repack", out[0], str(tmp_path / "again")]) == 0
    for name in ("params.bin", "model.json"):
        assert _read(str(tmp_path / "again"), name) == _read(out[0], name), name


def test_repack_refuses_a_v1_artifact(tmp_path, capsys):
    """Deviation 14: a ``tpusc.v1`` (flax msgpack) artifact needs flax and
    msgpack to read; the port exits 2 and names the JAX package's repack as
    the converter, and writes nothing."""
    src = tmp_path / "old" / "1"
    src.mkdir(parents=True)
    (src / "model.json").write_text(json.dumps({"format": "tpusc.v1", "family": "half_plus_two",
                                                "config": {}}))
    (src / "params.msgpack").write_bytes(b"\x80")
    assert cli.main(["repack", str(src), str(tmp_path / "new")]) == 2
    assert "python -m tfservingcache_tpu.cli repack" in capsys.readouterr().err
    assert not (tmp_path / "new").exists()


def test_repack_of_a_missing_artifact_raises(tmp_path):
    with pytest.raises(treg.ArtifactError):
        cli.main(["repack", str(tmp_path / "none"), str(tmp_path / "out")])


# -- warm ----------------------------------------------------------------------

def _warmed(line: str) -> tuple[str, list[str]]:
    """-> (the "<id> (<family>)" head, the list of what ran)."""
    assert line.startswith("warmed "), line
    head, rest = line[len("warmed "):].split(": ", 1)
    return head, rest.rsplit(" in ", 1)[0].split(", ")


@pytest.mark.parametrize("family,config,batches", [
    ("t5", T5_TINY, "1,2"), ("transformer_lm", LM_TINY, "2,1,2"),
    ("transformer_lm", dict(LM_TINY, max_seq=512), "1")], ids=["t5", "lm_clamped", "lm"])
def test_warm_runs_the_references_programs(tmp_path, monkeypatch, capsys, family, config,
                                           batches):
    """``warm`` runs what the reference's ``_warm`` compiles (each batch
    bucket, the LM's generate, both clamped to ``max_seq``), says on the CPU
    that nothing was built, and needs no ``compile_cache_dir``."""
    from jax._src import compilation_cache as cc

    art = jreg.export_artifact(family, str(tmp_path / "store"), name="w", version=2,
                               config=config, seed=1)
    monkeypatch.setenv("TPUSC_SERVING_DEVICE", "cpu")
    assert cli.main(["warm", art, "--batches", batches, "--lm-seq", "128"]) == 0
    got = capsys.readouterr().out.strip()
    assert got.endswith("-> nothing built (cpu: the plain path)"), got
    monkeypatch.setenv("TPUSC_SERVING_PLATFORM", "cpu")
    monkeypatch.setenv("TPUSC_SERVING_COMPILE_CACHE_DIR", str(tmp_path / "xla"))
    prior = jax.config.jax_compilation_cache_dir
    cc.reset_cache()
    try:
        assert jcli.main(["warm", art, "--batches", batches, "--lm-seq", "128"]) == 0
    finally:
        jax.config.update("jax_compilation_cache_dir", prior)
        cc.reset_cache()
    want = capsys.readouterr().out.strip()
    assert _warmed(got) == _warmed(want) == (f"w@2 ({family})", _warmed(want)[1])
    assert _warmed(got)[1][0] == "predict b=1"
