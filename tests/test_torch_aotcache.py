"""The port's kernel-library cache (``_build.py``, ``engine/aotcache.py``,
``engine/prewarm.py``) with a stand-in nvcc.

The stand-in is a script that ``CUDA_HOME`` points to: ``--version``
prints a release line, and a build writes a real shared library made by
the host C compiler from a one-line C file (and appends to a log, which
counts its runs). Checked:

- two prewarms into one directory: the first misses every library of the
  variant, the second hits them all and runs nvcc zero times;
- an edited source, other flags or another toolkit release line misses;
- a failing nvcc raises with its output and leaves nothing under the
  library's name;
- the hit and miss counters and the compile-time histogram move by the
  right amounts;
- ``compile_fingerprint`` names each variant's libraries, and a JAX
  config's ``aot_cache_dir`` survives ``FrameworkConfig.from_dict``;
- ``ServeApp`` places ``aot_cache_dir`` by the JAX app's rule, and its
  ``boot_phases`` carry the JAX keys (restore_s, cache_load_s, compile_s,
  upload_s);
- the prewarm CLI exits non-zero without nvcc and without a card.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import stat
import subprocess
import sys

import pytest

from tests.torch_port_helpers import write_feature_files
from vilbert_multitask_tpu_torch import _build
from vilbert_multitask_tpu_torch.config import (
    EngineConfig,
    FrameworkConfig,
    ViLBertConfig,
)
from vilbert_multitask_tpu_torch.engine import AotCache, compile_fingerprint
from vilbert_multitask_tpu_torch.engine.aotcache import default_cache_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL = ("flash_attn", "int8_linear", "nms", "roi_align")

NVCC = """#!/bin/sh
# stand-in nvcc: --version, or "-o OUT SOURCE" built from a C stub
if [ "$1" = "--version" ]; then
  echo "nvcc: NVIDIA (R) Cuda compiler driver"
  echo "Cuda compilation tools, release {release}, V{release}.0"
  exit 0
fi
echo "$@" >> "{log}"
if [ -n "$FAKE_NVCC_FAIL" ]; then
  echo "error: stand-in nvcc refuses $FAKE_NVCC_FAIL"
  exit 1
fi
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo "ptxas info    : Used 1 registers"
exec cc -shared -fPIC -o "$out" "{stub}"
"""


def _toolkit(tmp, release: str) -> str:
    """A CUDA_HOME whose bin/nvcc is the stand-in, naming ``release``."""
    home = tmp / f"cuda-{release}"
    (home / "bin").mkdir(parents=True)
    stub = tmp / "stub.c"
    stub.write_text("int vmt_stub(void) { return 7; }\n")
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(NVCC.format(release=release, log=tmp / "nvcc.log",
                                stub=stub))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return str(home)


def _runs(tmp) -> int:
    log = tmp / "nvcc.log"
    return len(log.read_text().splitlines()) if log.exists() else 0


@pytest.fixture
def toolkit(tmp_path, monkeypatch):
    """The stand-in toolkit on CUDA_HOME, and a process state of its own:
    no library loaded, no release line read."""
    if shutil.which("cc") is None:
        pytest.fail("the stand-in nvcc needs the host C compiler (cc)")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_TOOLKITS", {})
    monkeypatch.setenv("CUDA_HOME", _toolkit(tmp_path, "12.4"))
    monkeypatch.delenv("FAKE_NVCC_FAIL", raising=False)
    return tmp_path


def _cfg(**engine) -> FrameworkConfig:
    return FrameworkConfig(model=ViLBertConfig().tiny(),
                           engine=EngineConfig(**engine))


def _counts(names):
    return {n: (_build.HITS.value(program=n), _build.MISSES.value(program=n))
            for n in names}


@pytest.mark.parametrize("engine,live,want", [
    ({}, False, ["flash_attn"]),
    ({"param_dtype": "int8"}, False, ["flash_attn", "int8_linear"]),
    ({}, True, ["flash_attn", "nms", "roi_align"]),
    ({"param_dtype": "int8"}, True, list(ALL)),
    ({"use_pallas_coattention": False, "use_pallas_self_attention": False},
     False, []),
])
def test_fingerprint_names_each_variants_libraries(toolkit, engine, live,
                                                   want):
    fp = compile_fingerprint(_cfg(**engine), live_extract=live)
    assert fp["libraries"] == want
    assert fp["toolkit"] == "Cuda compilation tools, release 12.4, V12.4.0"
    assert fp["flags"] == list(_build.NVCC_FLAGS)
    assert set(fp["files"]) == set(want)


def test_second_prewarm_hits_every_library_and_runs_no_nvcc(toolkit):
    root = str(toolkit / "cache")
    fp = compile_fingerprint(_cfg(param_dtype="int8"), live_extract=True)
    before = _counts(ALL)
    compiles = _build.COMPILE_MS.count()
    cold = AotCache(root, fp)
    assert cold.prefetch() == 0
    first = cold.join()
    assert {n: r["status"] for n, r in first["libraries"].items()} == \
        dict.fromkeys(ALL, "built")
    assert first["misses"] == 4 and first["compile_s"] > 0
    assert _runs(toolkit) == 4
    assert _build.COMPILE_MS.count() == compiles + 4
    warm = AotCache(root, fp)
    assert warm.prefetch() == 4
    second = warm.join()
    assert {n: r["status"] for n, r in second["libraries"].items()} == \
        dict.fromkeys(ALL, "hit")
    assert second["misses"] == 0 and second["compile_s"] == 0.0
    assert _runs(toolkit) == 4  # no nvcc run
    after = _counts(ALL)
    for n in ALL:  # one miss and one hit each
        assert after[n] == (before[n][0] + 1, before[n][1] + 1), n
    for n, rec in second["libraries"].items():
        assert os.path.dirname(rec["path"]) == os.path.abspath(root)
        assert _build.load(n).vmt_stub() == 7


def test_edited_source_other_flags_or_toolkit_miss(toolkit, monkeypatch):
    root = str(toolkit / "cache")
    _build.build(["flash_attn"], root=root)
    assert _runs(toolkit) == 1
    _build.build(["flash_attn"], root=root)
    assert _runs(toolkit) == 1
    # other flags
    _build.build(["flash_attn"], _build.NVCC_FLAGS + ("-DVMT_X",), root=root)
    assert _runs(toolkit) == 2
    # another toolkit's release line
    monkeypatch.setenv("CUDA_HOME", _toolkit(toolkit, "12.8"))
    assert _build.toolkit_release().endswith("release 12.8, V12.8.0")
    _build.build(["flash_attn"], root=root)
    assert _runs(toolkit) == 3
    # an edited source
    src = toolkit / "csrc"
    shutil.copytree(_build.SOURCE_DIR, src)
    monkeypatch.setattr(_build, "SOURCE_DIR", str(src))
    _build.build(["flash_attn"], root=root)
    assert _runs(toolkit) == 3
    with open(src / "flash_attn.cu", "a") as f:
        f.write("\n// edited\n")
    _build.build(["flash_attn"], root=root)
    assert _runs(toolkit) == 4
    assert len([f for f in os.listdir(root) if f.endswith(".so")]) == 4


def test_failing_nvcc_raises_with_its_output_and_leaves_nothing(
        toolkit, monkeypatch):
    root = toolkit / "cache"
    monkeypatch.setenv("FAKE_NVCC_FAIL", "this source")
    misses = _build.MISSES.value(program="nms")
    cache = AotCache(str(root), {"libraries": ["nms"]})
    cache.prefetch()
    with pytest.raises(RuntimeError, match="stand-in nvcc refuses this "
                                           "source"):
        cache.join()
    assert not [f for f in os.listdir(root) if not f.endswith(".log")]
    assert _build.MISSES.value(program="nms") == misses + 1
    assert "nms" not in {k[0] for k in _build._LIBS}


def test_kernel_cache_boot_phases(toolkit):
    from vilbert_multitask_tpu_torch.serve.app import _join_kernel_cache

    info: dict = {}
    phases = _join_kernel_cache(AotCache(str(toolkit / "c"), compile_fingerprint(
        _cfg())), info)
    assert set(phases) == {"cache_load_s", "compile_s", "nvcc_s"}
    assert phases["compile_s"] > 0
    assert info["aot_cache"]["libraries"]["flash_attn"]["status"] == "built"
    again = _join_kernel_cache(AotCache(str(toolkit / "c"),
                                        compile_fingerprint(_cfg())), {})
    assert again["compile_s"] == 0.0
    assert _join_kernel_cache(None, {}) == {"cache_load_s": 0.0,
                                            "compile_s": 0.0}


def _serving(tmp, **engine):
    cfg = _cfg(compute_dtype="float32", max_regions=11, image_buckets=(1, 2),
               throughput_buckets=None, **engine)
    return dataclasses.replace(cfg, serving=dataclasses.replace(
        cfg.serving, queue_db_path=str(tmp / "state" / "q.sqlite3"),
        results_db_path=str(tmp / "state" / "r.sqlite3"),
        media_root=str(tmp / "media"), http_port=0, ws_port=0))


def test_serveapp_places_the_cache_by_the_jax_rule_and_books_boot_phases(
        tmp_path):
    from vilbert_multitask_tpu_torch.checkpoint.store import save_params
    from vilbert_multitask_tpu_torch.engine.runtime import init_state_dict
    from vilbert_multitask_tpu_torch.serve.app import ServeApp

    (tmp_path / "state").mkdir()
    feats = tmp_path / "features"
    feats.mkdir()
    write_feature_files(str(feats), 32, ["img_a"])
    cfg = _serving(tmp_path)
    ckpt = tmp_path / "weights" / "ckpt"
    save_params(str(ckpt), init_state_dict(cfg.model, seed=0))
    # The JAX app's rule (vilbert_multitask_tpu/serve/app.py:69-78).
    assert default_cache_dir(cfg) == str(tmp_path / "state" / "aot_cache")
    assert default_cache_dir(cfg, str(ckpt)) == str(
        tmp_path / "weights" / "aot_cache")
    explicit = _serving(tmp_path, aot_cache_dir=str(tmp_path / "mine"))
    assert default_cache_dir(explicit, str(ckpt)) == str(tmp_path / "mine")
    app = ServeApp(cfg, feature_root=str(feats), checkpoint_path=str(ckpt),
                   device="cpu")
    try:
        assert app.cfg.engine.aot_cache_dir == str(
            tmp_path / "weights" / "aot_cache")
        phases = app.boot_info["boot_phases"]
        assert {"restore_s", "cache_load_s", "compile_s",
                "upload_s"} <= set(phases)
        assert phases["restore_s"] > 0 and phases["upload_s"] > 0
    finally:
        app.stop()
    plain = ServeApp(cfg, feature_root=str(feats), device="cpu")
    try:
        assert plain.cfg.engine.aot_cache_dir == str(
            tmp_path / "state" / "aot_cache")
    finally:
        plain.stop()


def test_a_jax_config_keeps_its_aot_cache_dir():
    from vilbert_multitask_tpu.config import EngineConfig as JaxEngineConfig
    from vilbert_multitask_tpu.config import FrameworkConfig as JaxFramework

    jcfg = JaxFramework(engine=JaxEngineConfig(aot_cache_dir="/srv/aot"))
    port = FrameworkConfig.from_dict(dataclasses.asdict(jcfg))
    assert port.engine.aot_cache_dir == "/srv/aot"
    assert FrameworkConfig().engine.aot_cache_dir is None


@pytest.mark.parametrize("nvcc", [False, True])
def test_prewarm_cli_exits_nonzero_without_nvcc_or_card(tmp_path, nvcc):
    """Without nvcc it stops there; with the stand-in nvcc it stops at the
    missing card (this machine has none). Either way nothing is built."""
    env = dict(os.environ, PYTHONPATH=REPO,
               PATH=os.path.dirname(sys.executable) + os.pathsep + "/bin")
    env["CUDA_HOME"] = (_toolkit(tmp_path, "12.4") if nvcc
                        else str(tmp_path / "no-cuda"))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.fail("this test expects a machine without a CUDA toolkit")
    proc = subprocess.run(
        [sys.executable, "-m", "vilbert_multitask_tpu_torch.engine.prewarm",
         "--cache-dir", str(tmp_path / "cache")], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert ("no CUDA device" if nvcc else "nvcc not found") in proc.stderr
    assert proc.stdout == ""
    assert not (tmp_path / "cache").exists()
