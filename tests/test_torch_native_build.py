"""The port's kernel build on the CPU: nvcc's report is kept beside each
library and read back when the library is found built, and chip_smoke.py's
phase-2 check reads that report (registers, spills, ignored setmaxnreg) of
the Hopper flash kernels. A stand-in nvcc (a shell script) writes the
library and prints a report; no CUDA toolkit is needed."""

import importlib.util
import os
import stat

import pytest

from kubeflow_tpu_torch.native import build

_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def _entry(kernel, d, regs=168, spill=(0, 0)):
    name = f"_ZN12_GLOBAL__N_1{len(kernel)}{kernel}ILi{d}EEEv14CUtensorMap_st"
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {spill[0]} bytes spill stores, "
            f"{spill[1]} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers\n")


def _report(**spills):
    return "".join(_entry(k, d, spill=spills.get(f"{k}_{d}", (0, 0)))
                   for k in smoke.HOPPER_KERNELS for d in (16, 64, 128))


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """build.py pointed at a scratch source tree and an nvcc that copies
    its input to the -o path and prints a report; returns the call log."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel source\n")
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo run >> {calls}\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        'cp "$3" "$2"\n'
        "echo 'ptxas info    : Used 42 registers'\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(out))
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build, "build_logs", {})
    return calls


def test_report_is_kept_beside_the_library_and_read_back(fake_nvcc):
    path = build.build_all(["k"])["k"]
    assert os.path.exists(path) and "Used 42 registers" in build.build_logs["k"]
    with open(path + ".log") as f:
        assert "Used 42 registers" in f.read()
    # a later process finds the library built: no nvcc, the saved report
    build.build_logs.clear()
    build.build_all(["k"])
    assert fake_nvcc.read_text().count("run") == 1
    assert "Used 42 registers" in build.build_logs["k"]


def test_a_library_without_its_report_is_built_again(fake_nvcc):
    path = build.build_all(["k"])["k"]
    os.remove(path + ".log")
    build.build_logs.clear()
    build.build_all(["k"])
    assert fake_nvcc.read_text().count("run") == 2
    assert os.path.exists(path + ".log")


def test_phase_two_reads_registers_of_every_hopper_instance():
    report = smoke.hopper_kernel_report(_report())
    assert set(report) == {(k, d) for k in smoke.HOPPER_KERNELS
                           for d in (16, 64, 128)}
    assert all(r == (168, 0, 0) for r in report.values())


@pytest.mark.parametrize("bad", ["spill", "setmaxnreg", "missing"])
def test_phase_two_refuses_spills_ignored_setmaxnreg_and_gaps(bad):
    log = _report()
    if bad == "spill":
        log = _report(flash_bwd_dkv_bf16_128=(8, 8))
    elif bad == "setmaxnreg":
        log += ("ptxas warning : (C7508) setmaxnreg ignored; unable to "
                "determine register count at entry\n")
    else:
        log = log.split("ptxas info    : Compiling entry function")
        log = "ptxas info    : Compiling entry function".join(log[:-1])
    with pytest.raises(AssertionError):
        smoke.hopper_kernel_report(log)
