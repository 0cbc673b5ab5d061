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


@pytest.mark.parametrize("nested", [False, True], ids=["direct", "nested"])
def test_a_header_edit_builds_a_new_library(fake_nvcc, nested):
    """Every header a source includes with quotes, directly or through
    another header, is hashed into the library's name: after an edit of
    the header the next build runs nvcc again instead of loading the stale
    library; system headers (<...>) are not followed."""
    csrc = build.CSRC_DIR
    with open(os.path.join(csrc, "k.cu"), "w") as f:
        f.write('#include <cuda.h>\n#include "a.cuh"\n// a kernel source\n')
    with open(os.path.join(csrc, "a.cuh"), "w") as f:
        f.write('  #  include "b.cuh"\n' if nested else "// a header\n")
    with open(os.path.join(csrc, "b.cuh"), "w") as f:
        f.write("// a nested header\n")
    assert build.source_files("k") == (["k.cu", "a.cuh", "b.cuh"] if nested
                                       else ["k.cu", "a.cuh"])
    first = build.build_all(["k"])["k"]
    assert build.build_all(["k"])["k"] == first
    edited = "b.cuh" if nested else "a.cuh"
    with open(os.path.join(csrc, edited), "a") as f:
        f.write("// edited\n")
    second = build.build_all(["k"])["k"]
    assert second != first and os.path.exists(second)
    assert fake_nvcc.read_text().count("run") == 2


def test_a_missing_header_is_a_build_error(fake_nvcc):
    with open(os.path.join(build.CSRC_DIR, "k.cu"), "w") as f:
        f.write('#include "gone.cuh"\n')
    with pytest.raises(build.KernelBuildError, match="gone.cuh"):
        build.build_all(["k"])
    assert not os.path.exists(fake_nvcc)


def test_the_kernel_sources_hash_the_shared_hopper_header():
    """Both kernel sources include ops/csrc/hopper.cuh: it is part of each
    library's hash."""
    for name in build.kernel_sources():
        assert build.source_files(name) == [f"{name}.cu", "hopper.cuh"]


def _window_entry(kv, d, spill=(0, 0), compute="13__nv_bfloat16"):
    """ptxas's lines for paged_window_kernel<T, KV, D> as nvcc mangles it:
    T = bf16 is 13__nv_bfloat16, then KV = bf16 again (S1_) or int8 (a)."""
    name = (f"_ZN12_GLOBAL__N_119paged_window_kernelI{compute}{kv}Li{d}EEEv"
            f"14CUtensorMap_stS2_PKT_PKT0_PKS1_S8_PKiSC_PS3_PfP6float2Piiiiiiif")
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {spill[0]} bytes spill stores, "
            f"{spill[1]} bytes spill loads\n"
            f"ptxas info    : Used 128 registers, used 1 barriers\n")


def _window_report(spill_at=None):
    log = "".join(_window_entry(kv, d, spill=(8, 8) if (kv, d) == spill_at
                                else (0, 0))
                  for kv in ("S1_", "a") for d in (16, 64, 128))
    # the f32 instances (CUDA cores) are not Hopper kernels of phase 2
    return log + _window_entry("f", 64, compute="f") + _window_entry(
        "a", 64, compute="f")


def test_phase_two_reads_the_window_kernels_bf16_instances():
    report = smoke.hopper_kernel_report(_window_report(),
                                        smoke.WINDOW_HOPPER_KERNELS)
    assert set(report) == {(k, d) for k in smoke.WINDOW_HOPPER_KERNELS
                           for d in (16, 64, 128)}
    assert all(r == (128, 0, 0) for r in report.values())


@pytest.mark.parametrize("bad", ["spill", "missing"])
def test_phase_two_refuses_a_window_spill_or_gap(bad):
    if bad == "spill":
        log = _window_report(spill_at=("a", 128))
    else:
        log = _window_report().replace("S1_Li64E", "S1_Li32E")
    with pytest.raises(AssertionError):
        smoke.hopper_kernel_report(log, smoke.WINDOW_HOPPER_KERNELS)


def test_window_breakdown_cuts_the_kernel_where_it_says(tmp_path):
    """scripts/torch_window_breakdown.py's copies: `whole` is the source as
    it is, and each cut inserts its early return once, after its line of
    the window kernel (a kernel edit that moves a line fails here, not on
    the card)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "scripts", "torch_window_breakdown.py")
    spec = importlib.util.spec_from_file_location("window_breakdown", path)
    breakdown = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(breakdown)
    copies = breakdown.make_copies(os.path.dirname(path) + "/..", str(tmp_path))
    assert set(copies) == {"whole", *breakdown.CUTS}
    with open(os.path.join(build.CSRC_DIR, "paged_attention.cu")) as f:
        source = f.read()
    for cut, root in copies.items():
        with open(os.path.join(root, breakdown.SOURCE)) as f:
            text = f.read()
        if cut == "whole":
            assert text == source
        else:
            anchor, insert = breakdown.CUTS[cut]
            assert text == source.replace(anchor, anchor + insert)
            assert text.count("return;") == source.count("return;") + 1
