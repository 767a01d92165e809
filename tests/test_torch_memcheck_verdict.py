"""chip_smoke.py's verdict on the memory checker's run of the two-GEMM
route (``memcheck_route``, phase 5l), on the CPU.

The checker runs only on the card. Here ``subprocess.run`` answers with
the checker's output as it reads in each case, and the verdict is held
to what the phase must do with it:

- the checker's own "Device not supported" (the output it gives on a
  card it cannot check, with the "Program hit" line of the broken CUDA
  runtime that follows it): not checked, reported, no failure;
- a clean run (the script's line, "ERROR SUMMARY: 0 errors", exit 0):
  checked;
- an out-of-bounds read (the kernel killed, the script's synchronize
  raising, so its line never prints, exit 1), a non-zero summary alone,
  a non-zero exit alone, a missing summary, a time-out: the phase fails.
"""

import importlib.util
import subprocess
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
LINE = ("memcheck_route: factored_dense (640), factored_rows_tail (640, "
        "output), mlp_infer_tail (1152) ran, outputs finite")
BANNER = "========= COMPUTE-SANITIZER"
NOT_SUPPORTED = "\n".join([
    BANNER,
    "========= Error: Device not supported. Please refer to the "
    "\"Supported Devices\" section of the sanitizer documentation",
    "=========",
    "========= Program hit cudaErrorUnknown (error 999) due to \"unknown "
    "error\" on CUDA API call to cudaMalloc.",
    "=========     Saved host backtrace up to driver entry point at error",
    "RuntimeError: CUDA error: unknown error",
    "========= ERROR SUMMARY: 1 error"])
OOB = "\n".join([
    BANNER,
    "========= Invalid __global__ read of size 4 bytes",
    "=========     at void mamimo::mm::rows_gemm_kernel<false>(...)+0x1a40",
    "=========     Address 0x7f3a0c000a00 is out of bounds",
    "========= Program hit cudaErrorLaunchFailure (error 719) due to "
    "\"unspecified launch failure\" on CUDA API call to "
    "cudaDeviceSynchronize.",
    "RuntimeError: CUDA error: unspecified launch failure",
    "========= ERROR SUMMARY: 2 errors"])
CLEAN = "\n".join([BANNER, LINE, "========= ERROR SUMMARY: 0 errors"])


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _smoke()


def _verdict(monkeypatch, smoke, out, rc):
    """memcheck_route's answer, or the AssertionError it raises, with the
    checker present and answering `out` with exit code `rc` (None: the
    run timed out)."""
    monkeypatch.setattr("shutil.which", lambda name: "/bin/true")

    def run(cmd, **kw):
        assert cmd[1:3] == ["--tool", "memcheck"]
        assert kw["env"]["PYTORCH_NO_CUDA_MEMORY_CACHING"] == "1"
        if rc is None:
            raise subprocess.TimeoutExpired(cmd, kw["timeout"])
        return types.SimpleNamespace(stdout=out, stderr="", returncode=rc)

    monkeypatch.setattr(smoke.subprocess, "run", run)
    try:
        return smoke.memcheck_route(None)
    except AssertionError as e:
        return e


def test_memcheck_not_supported_is_reported(monkeypatch, smoke):
    got = _verdict(monkeypatch, smoke, NOT_SUPPORTED, 1)
    assert isinstance(got, dict) and got["ran"] is False
    assert "Device not supported" in got["reason"]


def test_memcheck_clean_run_is_checked(monkeypatch, smoke):
    got = _verdict(monkeypatch, smoke, CLEAN, 0)
    assert got == {"ran": True, "summary": "========= ERROR SUMMARY: 0 "
                   "errors", "seconds": got["seconds"]}


@pytest.mark.parametrize("out, rc", [
    (OOB, 1),                                             # the fault
    (OOB.replace("========= Invalid", "== Invalid"), 1),  # report unread
    (CLEAN.replace("0 errors", "1 error"), 0),            # summary alone
    (CLEAN, 1),                                           # exit alone
    (BANNER + "\n" + LINE, 0),                            # no summary
    ("", None),                                           # time-out
], ids=["out-of-bounds", "exit-and-summary", "summary", "exit",
        "no-summary", "timeout"])
def test_memcheck_faults_fail_the_phase(monkeypatch, smoke, out, rc):
    got = _verdict(monkeypatch, smoke, out, rc)
    assert isinstance(got, AssertionError), got
    assert "memcheck of the two-GEMM route" in str(got)
