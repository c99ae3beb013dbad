"""``chip_smoke.py``'s reading of a kernel library's SASS and of a profile,
on the CPU: which kernel a mangled name is, the rule that the Hopper kernels
(the CE forward and the stash-mode CE dx and dW kernels here) are present and
hold wgmma (HGMMA) and TMA tile loads (UTMALDG), and which kernel a profiled
launch belongs to; the same rule for the three flash kernels. Needs no card
and no ``cuobjdump``."""

import importlib.util
import os
import re
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CE_NS = "_ZN45_GLOBAL__N__402d3476_12_linear_ce_cu_50600954"
FLASH_NS = "_ZN46_GLOBAL__N__daeee7e7_13_flash_attn_cu_b294bfd0"
DW_SM90 = CE_NS + "17ce_dw_sm90_kernelILi4EEEv14CUtensorMap_stS1_PKiPKfS5_Pfiii"
DX_SM90 = CE_NS + "17ce_dx_sm90_kernelILi4EEEvNS_6DxMapsEPKiPKfS6_Pfiiii"
FWD_SM90 = CE_NS + "18ce_fwd_sm90_kernelILb1EEEvNS_7FwdMapsEPKiPfiiii"
FWD_SM90_RECOMPUTE = CE_NS + "18ce_fwd_sm90_kernelILb0EEEvNS_7FwdMapsEPKiPfiiii"
HOPPER_CE = (FWD_SM90, FWD_SM90_RECOMPUTE, DX_SM90, DW_SM90)
FLASH_FWD = FLASH_NS + "10fwd_kernelILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfxiiiiifii"
FLASH_DKV = (FLASH_NS
             + "10dkv_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_xiiiifi")
DQ_TAIL = "EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16xiiiiifii"
FLASH_DQ64 = FLASH_NS + "9dq_kernelILi64" + DQ_TAIL
FLASH_DQ128 = FLASH_NS + "9dq_kernelILi128" + DQ_TAIL
HOPPER_FLASH = (FLASH_FWD, FLASH_DQ64, FLASH_DQ128, FLASH_DKV)


@pytest.mark.parametrize("fn,name", [
    (DW_SM90, ("ce_dw_sm90_kernel", "4")),
    (DX_SM90, ("ce_dx_sm90_kernel", "4")),
    (FWD_SM90, ("ce_fwd_sm90_kernel", "1")),
    (FWD_SM90_RECOMPUTE, ("ce_fwd_sm90_kernel", "0")),
    (CE_NS + "12ce_dw_kernelEPK13__nv_bfloat16S2_PKiPKfS6_Pfiii", ("ce_dw_kernel", None)),
    (CE_NS + "21ce_fwd_combine_kernelEPKfPfS2_ii", ("ce_fwd_combine_kernel", None)),
    (CE_NS + "19ce_dx_reduce_kernelEPKfP13__nv_bfloat16xi", ("ce_dx_reduce_kernel", None)),
    (FLASH_DKV, ("dkv_kernel", "128")),
    (FLASH_FWD, ("fwd_kernel", "64")),
    (FLASH_DQ64, ("dq_kernel", "64")),
    (FLASH_DQ128, ("dq_kernel", "128")),
    ("_Z9somethingv", ("_Z9somethingv", None)),
])
def test_sass_kernel_name(smoke, fn, name):
    assert smoke.sass_kernel_name(fn) == name


def _sass(ops, fns=HOPPER_CE):
    """A SASS dump in which each function of ``fns`` holds ``ops``."""
    body = "".join(f"        /*0010*/ {op} R0, R1 ;\n" for op in ops)
    return "".join(f"\t\tFunction : {fn}\n" + body for fn in fns)


def _fake_dump(smoke, monkeypatch, tmp_path, sass):
    """A build whose ``cuobjdump`` prints ``sass``."""
    monkeypatch.setattr(smoke, "OUT", str(tmp_path))
    monkeypatch.setattr(smoke, "subprocess",
                        SimpleNamespace(run=lambda *a, **k: SimpleNamespace(stdout=sass)))
    return SimpleNamespace(nvcc=lambda: "/cuda/bin/nvcc", library_path=lambda src: src)


@pytest.mark.parametrize("ops,error", [
    (["HGMMA.64x64x16.F32.BF16", "UTMALDG.3D", "HGMMA.64x64x16.F32.BF16"], None),
    (["UTMALDG.3D", "LDGSTS.E.128"], "no HGMMA"),
    (["HGMMA.64x64x16.F32.BF16", "HMMA.16816.F32.BF16"], "no UTMALDG"),
    ([], "no HGMMA or UTMALDG"),
])
def test_check_sass_holds_the_dw_kernel_to_wgmma_and_tma(smoke, monkeypatch, tmp_path, ops,
                                                         error):
    """A dump of the Hopper CE kernels, each holding ``ops``."""
    sass = _sass(ops)
    for fn in HOPPER_CE:
        assert smoke.sass_counts(sass)[fn]["HGMMA"] == sum("HGMMA" in op for op in ops)
    build = _fake_dump(smoke, monkeypatch, tmp_path, sass)
    if error is None:
        smoke.check_sass(build, "linear_ce")
    else:
        with pytest.raises(AssertionError, match=error):
            smoke.check_sass(build, "linear_ce")
    # the flash source requires its own kernels, which this dump lacks
    with pytest.raises(AssertionError, match="no SASS found"):
        smoke.check_sass(build, "flash_attn")


@pytest.mark.parametrize("present,missing", [(DW_SM90, "ce_dx_sm90_kernel"),
                                             (DX_SM90, "ce_dw_sm90_kernel"),
                                             (DX_SM90, "ce_fwd_sm90_kernel")])
def test_check_sass_requires_both_hopper_ce_kernels(smoke, monkeypatch, tmp_path, present,
                                                    missing):
    """A dump that holds ``present`` and every other Hopper CE kernel but
    ``missing``, each with wgmma and TMA, still fails, naming the missing
    one."""
    fns = [present] + [fn for fn in HOPPER_CE
                       if fn != present and smoke.sass_kernel_name(fn)[0] != missing]
    sass = _sass(["HGMMA.64x256x16.F32.BF16", "UTMALDG.3D"], fns=fns)
    build = _fake_dump(smoke, monkeypatch, tmp_path, sass)
    with pytest.raises(AssertionError, match=re.escape(f"no SASS found for {{'{missing}'}}")):
        smoke.check_sass(build, "linear_ce")


@pytest.mark.parametrize("arg", ["true", "false"])
def test_step_kernels_counts_the_forward_without_its_combine_pass(smoke, arg):
    """Two profiled steps: the forward kernel (either mode) is ``ce_fwd``'s
    launch; its combine pass adds to ``ce_fwd``'s time but not to its
    launches, as dx's reduce pass does to ``ce_dx``'s."""
    ns = "(anonymous namespace)::"
    step = [
        (ns + f"ce_fwd_sm90_kernel<{arg}>(FwdMaps, int const*, float*, int, int, int, int)",
         0.0, 700.0),
        (ns + "ce_fwd_combine_kernel(float const*, float*, float*, int, int)", 700.0, 710.0),
        (ns + "ce_dx_sm90_kernel<4>(DxMaps, int const*, float const*, float const*, float*, "
         "int, int, int, int)", 800.0, 1450.0),
        (ns + "ce_dx_reduce_kernel(float const*, __nv_bfloat16*, long long, int)",
         1450.0, 1470.0),
        ("void at::native::elementwise_kernel<128, 4>(int, ...)", 1500.0, 1510.0),
    ]
    events = step + [(n, a + 5000.0, b + 5000.0) for n, a, b in step]
    kernels = smoke.step_kernels(events, 2)
    assert kernels["ce_fwd"] == {"launches_per_step": 1.0,
                                 "device_ms_per_step": pytest.approx(0.71)}
    assert kernels["ce_dx"] == {"launches_per_step": 1.0,
                                "device_ms_per_step": pytest.approx(0.67)}
    for name in ("ce_dw", "flash_fwd", "flash_dq", "flash_dkv"):
        assert kernels[name] == {"launches_per_step": 0.0, "device_ms_per_step": 0.0}


def test_check_sass_holds_the_flash_kernels_to_wgmma_and_tma(smoke, monkeypatch, tmp_path):
    """A dump of the forward, dQ (both head dims) and dK/dV kernels, each
    with wgmma and TMA tile loads, passes."""
    sass = _sass(["HGMMA.64x64x16.F32.BF16", "UTMALDG.3D"], fns=HOPPER_FLASH)
    smoke.check_sass(_fake_dump(smoke, monkeypatch, tmp_path, sass), "flash_attn")


def test_check_sass_requires_the_dq_kernel(smoke, monkeypatch, tmp_path):
    """Without dq_kernel the flash source fails, naming it."""
    fns = [fn for fn in HOPPER_FLASH if fn not in (FLASH_DQ64, FLASH_DQ128)]
    sass = _sass(["HGMMA.64x64x16.F32.BF16", "UTMALDG.3D"], fns=fns)
    build = _fake_dump(smoke, monkeypatch, tmp_path, sass)
    with pytest.raises(AssertionError, match=re.escape("no SASS found for {'dq_kernel'}")):
        smoke.check_sass(build, "flash_attn")


@pytest.mark.parametrize("ops,error", [(["HMMA.16816.F32.BF16", "UTMALDG.3D"], "no HGMMA"),
                                       (["HMMA.16816.F32.BF16"], "no HGMMA or UTMALDG")])
def test_check_sass_refuses_an_mma_sync_dq_kernel(smoke, monkeypatch, tmp_path, ops, error):
    """A dq_kernel that multiplies on mma.sync (HMMA) fails, named with its
    head dim, though the other flash kernels hold wgmma and TMA."""
    hopper = _sass(["HGMMA.64x64x16.F32.BF16", "UTMALDG.3D"], fns=(FLASH_FWD, FLASH_DKV))
    sass = hopper + _sass(ops, fns=(FLASH_DQ64,))
    build = _fake_dump(smoke, monkeypatch, tmp_path, sass)
    with pytest.raises(AssertionError, match=re.escape(f"dq_kernel<64> in flash_attn: {error}")):
        smoke.check_sass(build, "flash_attn")


def test_step_kernels_counts_each_flash_kernel(smoke):
    """Two profiled steps of one layer: each flash kernel, dQ among them,
    is one launch of its own wrapper per step."""
    ns = "(anonymous namespace)::"
    step = [
        (ns + "fwd_kernel<64>(CUtensorMap, CUtensorMap, CUtensorMap, __nv_bfloat16*, float*, "
         "long long, int, int, int, int, int, float, int, int)", 0.0, 17.0),
        (ns + "dq_kernel<64>(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, float const*, "
         "float const*, __nv_bfloat16*, long long, int, int, int, int, int, float, int, int)",
         100.0, 125.0),
        (ns + "dkv_kernel<64>(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, float const*, "
         "float const*, __nv_bfloat16*, __nv_bfloat16*, long long, int, int, int, int, float, "
         "int)", 125.0, 155.0),
        ("void at::native::elementwise_kernel<128, 4>(int, ...)", 160.0, 170.0),
    ]
    events = step + [(n, a + 1000.0, b + 1000.0) for n, a, b in step]
    kernels = smoke.step_kernels(events, 2)
    for name, ms in (("flash_fwd", 0.017), ("flash_dq", 0.025), ("flash_dkv", 0.030)):
        assert kernels[name] == {"launches_per_step": 1.0,
                                 "device_ms_per_step": pytest.approx(ms)}
    for name in ("ce_fwd", "ce_dx", "ce_dw"):
        assert kernels[name] == {"launches_per_step": 0.0, "device_ms_per_step": 0.0}


def _interval(task, config, k=8, windows=1, restored=False):
    return {"task": task, "config": config, "k": k, "windows": windows, "restored": restored}


FLASH_CFG, DENSE_CFG = {"attention": "flash"}, {"attention": "dense"}


@pytest.mark.parametrize("intervals,error", [
    ([_interval("a", FLASH_CFG, restored=False), _interval("a", FLASH_CFG),
      _interval("b", DENSE_CFG, k=3), _interval("b", FLASH_CFG, restored=True)], None),
    ([_interval("a", FLASH_CFG), _interval("a", FLASH_CFG, restored=True)], "did not change"),
    ([_interval("a", FLASH_CFG, k=4), _interval("a", FLASH_CFG, k=4)], "no interval ran windows"),
    ([_interval("a", FLASH_CFG, windows=0), _interval("a", FLASH_CFG, windows=0)],
     "no interval ran windows"),
    ([_interval("a", FLASH_CFG), _interval("b", FLASH_CFG)], "no task ran two intervals"),
])
def test_check_intervals(smoke, intervals, error):
    """Phase 3 holds its intervals to windows of 8 and to no restore where a
    task's config did not change."""
    if error is None:
        assert smoke.check_intervals(intervals) == 1
    else:
        with pytest.raises(AssertionError, match=error):
            smoke.check_intervals(intervals)


@pytest.mark.parametrize("windowed,eager,want", [
    ([5.25, 5.0], [5.25, 5.0], "bitwise"),
    ([5.25, 5.000004], [5.25, 5.0], "within 1e-05"),
    ([5.25, 5.0001], [5.25, 5.0], "above 1e-05"),
    ([5.25], [5.25, 5.0], "windowed losses against"),
])
def test_compare_windowed(smoke, windowed, eager, want):
    """Phase 4's windowed losses against the eager ones: bitwise, within
    WINDOW_ATOL (and how far), or a failure."""
    if want.startswith("above") or want.endswith("against"):
        with pytest.raises(AssertionError, match=want):
            smoke.compare_windowed("flash", windowed, eager)
    else:
        assert smoke.compare_windowed("flash", windowed, eager).startswith(want)


@pytest.mark.parametrize("attention,loss_fn,steps,flash_n,ce_n", [
    ("flash", None, 1, 12, 1),
    ("flash", "untagged", 10, 120, 0),
    ("dense", None, 10, 0, 10),
])
def test_want_launches(smoke, attention, loss_fn, steps, flash_n, ce_n):
    """What phases 4 and 5 hold the counts to: one launch of each flash
    kernel per layer per step with flash attention, one of each CE kernel
    per step on the fused head."""
    want = smoke.want_launches(attention, loss_fn, steps)
    assert want == {**{n: flash_n for n in smoke.FLASH_NAMES},
                    **{n: ce_n for n in smoke.CE_NAMES}}
