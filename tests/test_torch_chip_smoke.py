"""``chip_smoke.py``'s reading of a kernel library's SASS and of a profile,
on the CPU: which kernel a mangled name is, the rule that the Hopper kernels
(the CE forward, ds, dx and dW kernels here) are present and hold wgmma
(HGMMA) and TMA tile loads (UTMALDG), and which kernel a profiled launch
belongs to (a recompute-mode slab loop is one launch of its wrapper); the
same rule for the three flash kernels. Needs no card
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
DW_SM90 = CE_NS + "17ce_dw_sm90_kernelILi4ELb0EEEvNS_6DwMapsEPfiii"
DX_SM90 = CE_NS + "17ce_dx_sm90_kernelILi4ELb0EEEvNS_6DxMapsEPKiPKfS6_Pfiiiii"
DW_SM90_GIVEN = CE_NS + "17ce_dw_sm90_kernelILi3ELb1EEEvNS_6DwMapsEPfiii"
DX_SM90_GIVEN = CE_NS + "17ce_dx_sm90_kernelILi3ELb1EEEvNS_6DxMapsEPKiPKfS6_Pfiiiii"
DS_SM90 = CE_NS + "17ce_ds_sm90_kernelENS_7FwdMapsEPKiPKfS5_iiiii"
FWD_SM90 = CE_NS + "18ce_fwd_sm90_kernelILb1EEEvNS_7FwdMapsEPKiPfiiii"
FWD_SM90_RECOMPUTE = CE_NS + "18ce_fwd_sm90_kernelILb0EEEvNS_7FwdMapsEPKiPfiiii"
HOPPER_CE = (FWD_SM90, FWD_SM90_RECOMPUTE, DS_SM90, DX_SM90, DW_SM90, DX_SM90_GIVEN, DW_SM90_GIVEN)
FLASH_FWD = FLASH_NS + "10fwd_kernelILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfxiiiiifii"
FLASH_DKV = (FLASH_NS
             + "10dkv_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_xiiiifi")
DQ_TAIL = "EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16xiiiiifii"
FLASH_DQ64 = FLASH_NS + "9dq_kernelILi64" + DQ_TAIL
FLASH_DQ128 = FLASH_NS + "9dq_kernelILi128" + DQ_TAIL
FLASH_FWD_PP = FLASH_NS + "19fwd_pingpong_kernelE14CUtensorMap_stS0_S0_S0_Pfiiiifii"
FLASH_DKV_WIDE = (FLASH_NS + "15dkv_wide_kernelE14CUtensorMap_stS0_S0_S0_PKfS2_P13__nv_bfloat16"
                  "S4_xiiiiifii")
FLASH_DQ_WIDE = FLASH_NS + "14dq_wide_kernelE14CUtensorMap_stS0_S0_S0_S0_PKfS2_iiiifi"
HOPPER_FLASH = (FLASH_FWD, FLASH_DQ64, FLASH_DQ128, FLASH_DKV)
#: What the head-dim-256 kernels' SASS holds: wgmma, TMA tile loads, setmaxnreg.
SETMAXREG_OPS = ("HGMMA.64x256x16.F32.BF16", "UTMALDG.3D", "USETMAXREG.DEALLOC")


@pytest.mark.parametrize("fn,name", [
    (DW_SM90, ("ce_dw_sm90_kernel", "4,0")),
    (DX_SM90, ("ce_dx_sm90_kernel", "4,0")),
    (DW_SM90_GIVEN, ("ce_dw_sm90_kernel", "3,1")),
    (DX_SM90_GIVEN, ("ce_dx_sm90_kernel", "3,1")),
    (DS_SM90, ("ce_ds_sm90_kernel", None)),
    (FWD_SM90, ("ce_fwd_sm90_kernel", "1")),
    (FWD_SM90_RECOMPUTE, ("ce_fwd_sm90_kernel", "0")),
    (CE_NS + "12ce_dw_kernelEPK13__nv_bfloat16S2_PKiPKfS6_Pfiii", ("ce_dw_kernel", None)),
    (CE_NS + "21ce_fwd_combine_kernelEPKfPfS2_ii", ("ce_fwd_combine_kernel", None)),
    (CE_NS + "19ce_dx_reduce_kernelEPKfP13__nv_bfloat16xi", ("ce_dx_reduce_kernel", None)),
    (FLASH_DKV, ("dkv_kernel", "128")),
    (FLASH_FWD, ("fwd_kernel", "64")),
    (FLASH_DQ64, ("dq_kernel", "64")),
    (FLASH_DQ128, ("dq_kernel", "128")),
    (FLASH_FWD_PP, ("fwd_pingpong_kernel", None)),
    (FLASH_DKV_WIDE, ("dkv_wide_kernel", None)),
    (FLASH_DQ_WIDE, ("dq_wide_kernel", None)),
    ("_Z9somethingv", ("_Z9somethingv", None)),
])
def test_sass_kernel_name(smoke, fn, name):
    assert smoke.sass_kernel_name(fn) == name


def _sass(ops, fns=HOPPER_CE):
    """A SASS dump in which each function of ``fns`` holds ``ops``."""
    body = "".join(f"        /*0010*/ {op} R0, R1 ;\n" for op in ops)
    return "".join(f"\t\tFunction : {fn}\n" + body for fn in fns)


def _flash_sass(ops, pingpong=SETMAXREG_OPS, fns=HOPPER_FLASH, wide=SETMAXREG_OPS,
                dq_wide=SETMAXREG_OPS):
    """A dump of the flash kernels ``fns``, each holding ``ops``, of the
    head-dim-256 forward holding ``pingpong``, of the head-dim-256 dK/dV
    holding ``wide`` and of the head-dim-256 dQ holding ``dq_wide`` (None:
    left out)."""
    return (_sass(ops, fns=fns)
            + ("" if pingpong is None else _sass(pingpong, fns=(FLASH_FWD_PP,)))
            + ("" if wide is None else _sass(wide, fns=(FLASH_DKV_WIDE,)))
            + ("" if dq_wide is None else _sass(dq_wide, fns=(FLASH_DQ_WIDE,))))


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
                                             (DX_SM90, "ce_fwd_sm90_kernel"),
                                             (DX_SM90, "ce_ds_sm90_kernel")])
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


def test_step_kernels_counts_a_slab_loop_as_one_launch(smoke):
    """Two profiled steps with the CE head in recompute mode: each of dx and
    dW runs a ds kernel and its product kernel per vocab slab (two slabs
    here); each ds kernel's time goes to the wrapper whose product follows
    it, and each wrapper's slab loop is one launch, dx's ended by its reduce
    pass."""
    ns = "(anonymous namespace)::"
    ds = ns + ("ce_ds_sm90_kernel(FwdMaps, int const*, float const*, float const*, int, int, "
               "int, int, int)")
    dx = ns + ("ce_dx_sm90_kernel<4, true>(DxMaps, int const*, float const*, float const*, "
               "float*, int, int, int, int, int)")
    dw = ns + "ce_dw_sm90_kernel<4, true>(DwMaps, float*, int, int, int)"
    step = [
        (ns + "ce_fwd_sm90_kernel<false>(FwdMaps, int const*, float*, int, int, int, int)",
         0.0, 500.0),
        (ns + "ce_fwd_combine_kernel(float const*, float*, float*, int, int)", 500.0, 510.0),
        (ds, 600.0, 900.0), (dx, 900.0, 1200.0), (ds, 1200.0, 1300.0), (dx, 1300.0, 1400.0),
        (ns + "ce_dx_reduce_kernel(float const*, __nv_bfloat16*, long long, int)",
         1400.0, 1420.0),
        (ds, 1420.0, 1720.0), (dw, 1720.0, 2120.0), (ds, 2120.0, 2220.0), (dw, 2220.0, 2370.0),
        ("void at::native::elementwise_kernel<128, 4>(int, ...)", 2400.0, 2410.0),
    ]
    events = step + [(n, a + 5000.0, b + 5000.0) for n, a, b in step]
    kernels = smoke.step_kernels(events, 2)
    assert kernels["ce_fwd"] == {"launches_per_step": 1.0,
                                 "device_ms_per_step": pytest.approx(0.51)}
    assert kernels["ce_dx"] == {"launches_per_step": 1.0,
                                "device_ms_per_step": pytest.approx(0.82)}
    assert kernels["ce_dw"] == {"launches_per_step": 1.0,
                                "device_ms_per_step": pytest.approx(0.95)}


@pytest.mark.parametrize("run,launches", [
    ("p", 1), ("ps", 1), ("pp", 2), ("psps", 2), ("dp", 1), ("dpdp", 1), ("dpdps", 1),
    ("dpsdps", 2), ("dpsdp", 2),
    ("dpp", None), ("dpdpp", None), ("ddp", None), ("dps" + "s", None), ("s", None),
    ("pss", None), ("d", None), ("pd", None), ("dpd", None), ("dpdpsp", None),
    ("pdp", None), ("psdps", None),
])
def test_ce_run_launches(smoke, run, launches):
    """A CE wrapper's launch is p[s] or (dp)+[s]: stash-mode products in a
    row count one launch each (so the exact counts catch a kernel run twice
    in one call), and a product with no ds before it in a slab loop, two ds
    in a row, a second kernel with no product before it or a run mixing the
    two modes (a slab loop that lost its first ds event) raises."""
    if launches is None:
        with pytest.raises(smoke.LaunchShapeError, match="ran as"):
            smoke.ce_run_launches("ce_dx", run)
    else:
        assert smoke.ce_run_launches("ce_dx", run) == launches


def _recompute_step():
    """One step of the CE head in recompute mode, two vocab slabs."""
    ns = "(anonymous namespace)::"
    ds = (ns + "ce_ds_sm90_kernel(FwdMaps, int const*, float const*, float const*, int, int, "
          "int, int, int)", 300.0)
    dx = (ns + "ce_dx_sm90_kernel<4, true>(DxMaps, int const*, float const*, float const*, "
          "float*, int, int, int, int, int)", 300.0)
    dw = (ns + "ce_dw_sm90_kernel<4, true>(DwMaps, float*, int, int, int)", 400.0)
    return [(ns + "ce_fwd_sm90_kernel<false>(FwdMaps, int const*, float*, int, int, int, int)",
             500.0),
            (ns + "ce_fwd_combine_kernel(float const*, float*, float*, int, int)", 10.0),
            ds, dx, ds, dx, (ns + "ce_dx_reduce_kernel(float const*, __nv_bfloat16*, long long, "
                             "int)", 20.0),
            ds, dw, ds, dw]


def _timed(kernels):
    out, t = [], 0.0
    for name, us in kernels:
        out.append((name, t, t + us))
        t += us
    return out


@pytest.mark.parametrize("fault", ["dx product twice", "dw product twice", "ds twice",
                                   "reduce twice", "ds last"])
def test_step_kernels_rejects_a_slab_loop_out_of_shape(smoke, fault):
    """A recompute-mode step whose slab loop ran a kernel too many times
    fails, where counting each wrapper's run as one launch would hide it."""
    step = _recompute_step()
    i = {"dx product twice": 5, "dw product twice": 10, "ds twice": 7, "reduce twice": 6,
         "ds last": 9}[fault]
    step = step + [step[2]] if fault == "ds last" else step[:i + 1] + step[i:]
    with pytest.raises(smoke.LaunchShapeError, match="ran as|no CE kernel after it"):
        smoke.step_kernels(_timed(step * 2 if fault != "ds last" else step), 2)


def test_step_kernels_counts_a_stash_product_run_twice(smoke):
    """Stash mode: dW's product kernel run twice in a step counts as two
    launches, which the exact launch count then rejects."""
    ns = "(anonymous namespace)::"
    dw = (ns + "ce_dw_sm90_kernel<4, false>(DwMaps, float*, int, int, int)", 400.0)
    step = [(ns + "ce_fwd_sm90_kernel<true>(FwdMaps, int const*, float*, int, int, int, int)",
             500.0),
            (ns + "ce_dx_sm90_kernel<4, false>(DxMaps, int const*, float const*, float const*, "
             "float*, int, int, int, int, int)", 300.0), dw, dw]
    kernels = smoke.step_kernels(_timed(step * 2), 2)
    assert kernels["ce_dw"] == {"launches_per_step": 2.0,
                                "device_ms_per_step": pytest.approx(0.8)}
    assert kernels["ce_fwd"]["launches_per_step"] == kernels["ce_dx"]["launches_per_step"] == 1.0


def _flash_events(steps, drop=0, extra=0):
    """``steps`` steps of 12 launches of each flash kernel, less ``drop``
    forward launches, plus ``extra``."""
    ns = "(anonymous namespace)::"
    names = [ns + f"{k}_kernel<64>(...)" for k in ("fwd", "dq", "dkv")]
    events = [(n, 10.0 * i, 10.0 * i + 5) for i in range(12 * steps) for n in names]
    fwd = [e for e in events if "fwd_kernel" in e[0]]
    events = [e for e in events if e not in fwd[:drop]]
    return events + [(names[0], 1e6 + i, 1e6 + i + 1) for i in range(extra)]


@pytest.mark.parametrize("profiles,error,taken", [
    ([_flash_events(2)], None, 1),
    ([_flash_events(2, drop=1), _flash_events(2)], None, 2),
    ([_flash_events(2, drop=1)] * 3, "saw", 3),
    ([_flash_events(2, extra=1), _flash_events(2)], "saw", 1),
])
def test_counted_profile_retakes_a_profile_that_lost_events(smoke, monkeypatch, profiles,
                                                           error, taken):
    """A graph replays all of its launches: a profile short of the want lost
    trace events and is taken again (3 in all); one over the want fails.
    Every profile off the count is recorded, with its kernel and counts."""
    calls = []
    monkeypatch.setattr(smoke, "SHORT_PROFILES", [])

    def profiled(fn, n):
        calls.append(n)
        return None, profiles[len(calls) - 1]

    monkeypatch.setattr(smoke, "profiled", profiled)
    want = smoke.want_launches("flash", "untagged", 1)
    if error is None:
        _, _, kernels = smoke.counted_profile(lambda: None, 1, 2, want, "flash windows")
        assert kernels["flash_fwd"]["launches_per_step"] == 12
    else:
        with pytest.raises(AssertionError, match=error):
            smoke.counted_profile(lambda: None, 1, 2, want, "flash windows")
    assert calls == [1] * taken
    short = 1 if error == "saw" and taken == 1 else taken - (error is None)
    assert [r["attempt"] for r in smoke.SHORT_PROFILES] == list(range(1, short + 1))
    for r in smoke.SHORT_PROFILES:
        assert r["label"] == "flash windows" and list(r["short"]) == ["flash_fwd"]
        assert r["short"]["flash_fwd"][1] == 12


@pytest.mark.parametrize("bad", [1, 3])
def test_counted_profile_retakes_a_slab_loop_out_of_shape(smoke, monkeypatch, bad):
    """A recompute-mode profile that lost a ds event is out of shape: it is
    recorded and taken again, and raises when every attempt is."""
    step = _recompute_step()
    good = _timed(step * 2)
    lost = _timed(step[:7] + step[8:] + step)  # the first step lost a dw slab's ds
    profiles = [lost] * bad + [good]
    calls = []
    monkeypatch.setattr(smoke, "SHORT_PROFILES", [])

    def profiled(fn, n):
        calls.append(n)
        return None, profiles[len(calls) - 1]

    monkeypatch.setattr(smoke, "profiled", profiled)
    want = dict.fromkeys(smoke.KERNEL_SYMBOLS, 0.0)
    want.update(ce_fwd=1.0, ce_dx=1.0, ce_dw=1.0)
    if bad < 3:
        _, _, kernels = smoke.counted_profile(lambda: None, 1, 2, want, "recompute windows")
        assert kernels["ce_dw"]["launches_per_step"] == 1.0
    else:
        with pytest.raises(smoke.LaunchShapeError, match="ce_dw"):
            smoke.counted_profile(lambda: None, 1, 2, want, "recompute windows")
    assert len(calls) == min(bad + 1, 3)
    assert [r["attempt"] for r in smoke.SHORT_PROFILES] == list(range(1, bad + 1))
    assert all("ce_dw" in r["out_of_shape"] for r in smoke.SHORT_PROFILES)


def test_check_sass_holds_the_flash_kernels_to_wgmma_and_tma(smoke, monkeypatch, tmp_path):
    """A dump of the forward, dQ (both head dims) and dK/dV kernels, each
    with wgmma and TMA tile loads, and of the head-dim-256 forward, also with
    setmaxnreg, passes."""
    sass = _flash_sass(["HGMMA.64x64x16.F32.BF16", "UTMALDG.3D"])
    smoke.check_sass(_fake_dump(smoke, monkeypatch, tmp_path, sass), "flash_attn")


def test_check_sass_requires_the_dq_kernel(smoke, monkeypatch, tmp_path):
    """Without dq_kernel the flash source fails, naming it."""
    fns = [fn for fn in HOPPER_FLASH if fn not in (FLASH_DQ64, FLASH_DQ128)]
    sass = _flash_sass(["HGMMA.64x64x16.F32.BF16", "UTMALDG.3D"], fns=fns)
    build = _fake_dump(smoke, monkeypatch, tmp_path, sass)
    with pytest.raises(AssertionError, match=re.escape("no SASS found for {'dq_kernel'}")):
        smoke.check_sass(build, "flash_attn")


def test_check_sass_requires_the_pingpong_forward(smoke, monkeypatch, tmp_path):
    """Without fwd_pingpong_kernel (the head-dim-256 forward) the flash
    source fails, naming it, though every other flash kernel is there."""
    sass = _flash_sass(["HGMMA.64x64x16.F32.BF16", "UTMALDG.3D"], pingpong=None)
    build = _fake_dump(smoke, monkeypatch, tmp_path, sass)
    with pytest.raises(AssertionError,
                       match=re.escape("no SASS found for {'fwd_pingpong_kernel'}")):
        smoke.check_sass(build, "flash_attn")


@pytest.mark.parametrize("ops,error", [
    (["HGMMA.64x256x16.F32.BF16", "UTMALDG.3D"], "no USETMAXREG"),
    (["UTMALDG.3D", "USETMAXREG.TRY_ALLOC"], "no HGMMA"),
    (["HMMA.16816.F32.BF16"], "no HGMMA or UTMALDG or USETMAXREG"),
])
def test_check_sass_holds_the_pingpong_forward_to_setmaxnreg(smoke, monkeypatch, tmp_path, ops,
                                                             error):
    """The head-dim-256 forward must hold wgmma, TMA tile loads and
    setmaxnreg (its producer gives its registers to the consumers): one
    without fails, named, though the other flash kernels hold theirs."""
    sass = _flash_sass(["HGMMA.64x64x16.F32.BF16", "UTMALDG.3D"], pingpong=ops)
    build = _fake_dump(smoke, monkeypatch, tmp_path, sass)
    with pytest.raises(AssertionError,
                       match=re.escape(f"fwd_pingpong_kernel in flash_attn: {error}")):
        smoke.check_sass(build, "flash_attn")


def test_check_sass_requires_the_wide_dkv_kernel(smoke, monkeypatch, tmp_path):
    """Without dkv_wide_kernel (the head-dim-256 dK/dV) the flash source
    fails, naming it, though every other flash kernel is there."""
    sass = _flash_sass(["HGMMA.64x64x16.F32.BF16", "UTMALDG.3D"], wide=None)
    build = _fake_dump(smoke, monkeypatch, tmp_path, sass)
    with pytest.raises(AssertionError,
                       match=re.escape("no SASS found for {'dkv_wide_kernel'}")):
        smoke.check_sass(build, "flash_attn")


@pytest.mark.parametrize("ops,error", [
    (["HGMMA.64x256x16.F32.BF16", "UTMALDG.3D"], "no USETMAXREG"),
    (["UTMALDG.3D", "USETMAXREG.TRY_ALLOC"], "no HGMMA"),
    (["HGMMA.64x64x16.F32.BF16", "USETMAXREG.DEALLOC"], "no UTMALDG"),
])
def test_check_sass_holds_the_wide_dkv_kernel_to_setmaxnreg(smoke, monkeypatch, tmp_path, ops,
                                                            error):
    """The head-dim-256 dK/dV must hold wgmma, TMA tile loads and setmaxnreg
    (its producer gives its registers to the two consumers): one without
    fails, named, though the other flash kernels hold theirs."""
    sass = _flash_sass(["HGMMA.64x64x16.F32.BF16", "UTMALDG.3D"], wide=ops)
    build = _fake_dump(smoke, monkeypatch, tmp_path, sass)
    with pytest.raises(AssertionError,
                       match=re.escape(f"dkv_wide_kernel in flash_attn: {error}")):
        smoke.check_sass(build, "flash_attn")


def test_check_sass_requires_the_wide_dq_kernel(smoke, monkeypatch, tmp_path):
    """Without dq_wide_kernel (the head-dim-256 dQ) the flash source fails,
    naming it, though every other flash kernel is there."""
    sass = _flash_sass(["HGMMA.64x64x16.F32.BF16", "UTMALDG.3D"], dq_wide=None)
    build = _fake_dump(smoke, monkeypatch, tmp_path, sass)
    with pytest.raises(AssertionError,
                       match=re.escape("no SASS found for {'dq_wide_kernel'}")):
        smoke.check_sass(build, "flash_attn")


@pytest.mark.parametrize("ops,error", [
    (["HGMMA.64x256x16.F32.BF16", "UTMALDG.3D"], "no USETMAXREG"),
    (["UTMALDG.3D", "USETMAXREG.TRY_ALLOC"], "no HGMMA"),
    (["HGMMA.64x64x16.F32.BF16", "USETMAXREG.DEALLOC"], "no UTMALDG"),
])
def test_check_sass_holds_the_wide_dq_kernel_to_setmaxnreg(smoke, monkeypatch, tmp_path, ops,
                                                           error):
    """The head-dim-256 dQ must hold wgmma, TMA tile loads and setmaxnreg
    (its producer gives its registers to the two consumers): one without
    fails, named, though the other flash kernels hold theirs."""
    sass = _flash_sass(["HGMMA.64x64x16.F32.BF16", "UTMALDG.3D"], dq_wide=ops)
    build = _fake_dump(smoke, monkeypatch, tmp_path, sass)
    with pytest.raises(AssertionError,
                       match=re.escape(f"dq_wide_kernel in flash_attn: {error}")):
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


def test_step_kernels_counts_the_pingpong_forward(smoke):
    """At head dim 256 the forward is fwd_pingpong_kernel: one launch of
    ``flash_fwd`` per event, beside dQ and dK/dV at 256."""
    ns = "(anonymous namespace)::"
    step = [
        (ns + "fwd_pingpong_kernel(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, float*, "
         "int, int, int, int, float, int, int)", 0.0, 57.0),
        (ns + "dq_kernel<256>(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, float const*, "
         "float const*, __nv_bfloat16*, long long, int, int, int, int, int, float, int, int)",
         100.0, 210.0),
        (ns + "dkv_kernel<256>(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, float const*, "
         "float const*, __nv_bfloat16*, __nv_bfloat16*, long long, int, int, int, int, float, "
         "int)", 210.0, 475.0),
    ]
    events = step + [(n, a + 1000.0, b + 1000.0) for n, a, b in step]
    kernels = smoke.step_kernels(events, 2)
    for name, ms in (("flash_fwd", 0.057), ("flash_dq", 0.110), ("flash_dkv", 0.265)):
        assert kernels[name] == {"launches_per_step": 1.0,
                                 "device_ms_per_step": pytest.approx(ms)}


def test_step_kernels_counts_the_wide_dkv_kernel(smoke):
    """At head dim 256 dK/dV is dkv_wide_kernel: one launch of
    ``flash_dkv`` per event, beside the forward and dQ at 256."""
    ns = "(anonymous namespace)::"
    step = [
        (ns + "fwd_pingpong_kernel(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, float*, "
         "int, int, int, int, float, int, int)", 0.0, 57.0),
        (ns + "dq_kernel<256>(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, float const*, "
         "float const*, __nv_bfloat16*, long long, int, int, int, int, int, float, int, int)",
         100.0, 210.0),
        (ns + "dkv_wide_kernel(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, "
         "float const*, float const*, __nv_bfloat16*, __nv_bfloat16*, long long, int, int, int, "
         "int, int, float, int, int)", 210.0, 330.0),
    ]
    events = step + [(n, a + 1000.0, b + 1000.0) for n, a, b in step]
    kernels = smoke.step_kernels(events, 2)
    for name, ms in (("flash_fwd", 0.057), ("flash_dq", 0.110), ("flash_dkv", 0.120)):
        assert kernels[name] == {"launches_per_step": 1.0,
                                 "device_ms_per_step": pytest.approx(ms)}


def test_step_kernels_counts_the_wide_dq_kernel(smoke):
    """At head dim 256 dQ is dq_wide_kernel: one launch of ``flash_dq``
    per event, beside the forward and dK/dV at 256."""
    ns = "(anonymous namespace)::"
    step = [
        (ns + "fwd_pingpong_kernel(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, float*, "
         "int, int, int, int, float, int, int)", 0.0, 57.0),
        (ns + "dq_wide_kernel(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, "
         "float const*, float const*, int, int, int, int, float, int)", 100.0, 175.0),
        (ns + "dkv_wide_kernel(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, "
         "CUtensorMap, CUtensorMap, float const*, float const*, int, int, int, int, float, "
         "int, int)", 175.0, 275.0),
    ]
    events = step + [(n, a + 1000.0, b + 1000.0) for n, a, b in step]
    kernels = smoke.step_kernels(events, 2)
    for name, ms in (("flash_fwd", 0.057), ("flash_dq", 0.075), ("flash_dkv", 0.100)):
        assert kernels[name] == {"launches_per_step": 1.0,
                                 "device_ms_per_step": pytest.approx(ms)}


def test_flash_sweep_takes_the_median_window_and_flags_a_time_under_its_bound(
        smoke, monkeypatch):
    """The sweep times each function as phase 2 does: the median of three
    profiled windows that disagree (one short of device events). A time
    under its bound is taken again: dQ's second reading stands, SDPA's
    backward stays under its bound through three and is named in the row's
    ``under_bound``; CPU tensors through the plain versions, a stubbed
    profiler."""
    import torch

    from saturn_tpu_torch.ops import flash

    # ms per call of each profiled window, in the order the sweep takes them
    windows = [("fwd_ms", (0.5, 0.1, 0.3)),
               ("dq_ms", (1e-9, 2e-9, 3e-9)), ("dq_ms", (0.05, 0.07, 0.06)),
               ("dkv_ms", (0.2, 0.6, 0.4)), ("sdpa_fwd_ms", (0.7, 0.7, 0.2))]
    windows += [("sdpa_bwd_ms", (0.9, 1e-9, 1e-9))] * 3
    per_window = iter([ms for _, three in windows for ms in three])

    def profiled(fn, n):
        fn()
        return None, [("k", 0.0, next(per_window) * n * 1e3)]

    def inputs(B, H, KV, T, D, seed):
        g = torch.Generator().manual_seed(seed)
        return tuple(torch.randn((b, T, D), generator=g).to(torch.bfloat16)
                     for b in (B * H, B * KV, B * KV, B * H))

    monkeypatch.setattr(smoke, "profiled", profiled)
    monkeypatch.setattr(smoke, "kernel_inputs", inputs)
    monkeypatch.setattr(smoke.torch.cuda, "synchronize", lambda: None)
    (row,) = smoke.flash_sweep(flash, [(1, 2, 64, 64, True)])
    assert next(per_window, None) is None  # every window taken, no more
    assert row["fwd_ms"] == pytest.approx(0.3) and row["dkv_ms"] == pytest.approx(0.4)
    assert row["sdpa_fwd_ms"] == pytest.approx(0.7) and row["dq_ms"] == pytest.approx(0.06)
    assert row["sdpa_bwd_ms"] == pytest.approx(1e-9)
    assert row["retaken"] == {"dq_ms": 1, "sdpa_bwd_ms": 2}
    assert row["under_bound"] == ["sdpa_bwd_ms"]
    assert set(row["bound_ms"]) == {name for name, _ in windows}
    assert 0 < row["bound_ms"]["dq_ms"] < row["bound_ms"]["sdpa_bwd_ms"]


def test_flash_sweep_rows_at_head_dim_256(smoke):
    """The sweep holds GPT-J's heads at head dim 256 (B 8, H 16): causal T
    512, 1024 and 2048 and non-causal T 512; ``--head-dim`` picks them."""
    rows = [row for row in smoke.SWEEP if row[3] == int(smoke.option(
        ["--flash-sweep", "--head-dim", "256"], "--head-dim"))]
    assert rows == [(8, 16, 512, 256, True), (8, 16, 1024, 256, True),
                    (8, 16, 2048, 256, True), (8, 16, 512, 256, False)]
    assert smoke.option(["--flash-sweep"], "--root", "repo") == "repo"


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


# ------------------------------------------------------- phase 6's helpers
def test_poisoned_dataset_marks_one_batch(smoke):
    """Only batch MARKED_BATCH (modulo the epoch) has its first row marked;
    every other batch is the base dataset's."""
    import numpy as np

    from saturn_tpu_torch.data.lm_dataset import make_lm_dataset

    base = make_lm_dataset(context_length=16, batch_size=2, vocab_size=64, n_tokens=16 * 2 * 8)
    ds = smoke.PoisonedDataset(base, 5, 63)
    assert len(ds) == len(base) == 8 and ds.batch_size == 2
    for i in range(20):
        b = ds.batch(i)
        if i % 8 == 5:
            assert (b[0] == 63).all() and (b[1] == base.batch(i)[1]).all()
        else:
            np.testing.assert_array_equal(b, base.batch(i))
    assert not (base.batch(5)[0] == 63).all()  # the base is untouched


def test_nan_on_mark_loss_is_nan_only_on_the_mark(smoke, monkeypatch):
    """NaN on a marked batch, the pretraining loss elsewhere; the gradient
    stays finite on both, so a faulted step leaves finite weights."""
    import torch

    from saturn_tpu_torch.models.loss import pretraining_loss

    monkeypatch.setattr(smoke, "MARK", 63)
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 60, (2, 16), generator=g)
    for marked in (False, True):
        t = tokens.clone()
        if marked:
            t[0] = 63
        logits = torch.randn(2, 16, 64, generator=g, requires_grad=True)
        loss = smoke.nan_on_mark_loss(logits, t)
        assert torch.isnan(loss).item() is marked
        if not marked:
            assert loss.item() == pretraining_loss(logits, t).item()
        loss.backward()
        assert torch.isfinite(logits.grad).all()


@pytest.mark.parametrize("stats,error", [
    ({"trials_run": 2, "cache_hits": 11}, None),
    ({"trials_run": 13, "cache_hits": 0}, "ran 13 trials with 0 cache hits"),
    ({"trials_run": 2, "cache_hits": 10}, "want 2 and 11"),
])
def test_check_search_counts_trials_and_hits(smoke, stats, error):
    if error is None:
        smoke.check_search(stats, 2, 11)
    else:
        with pytest.raises(AssertionError, match=error):
            smoke.check_search(stats, 2, 11)


def test_checked_writes_refuse_a_non_finite_checkpoint(smoke, tmp_path):
    """Every write is checked for finite weights before it happens; the
    wrapper records every write's path and step in order, and counts the
    bytes."""
    import torch

    written = []

    def save_async(path, state):
        torch.save({"step": state["step"]}, path)
        written.append(path)

    ckpt = SimpleNamespace(save_async=save_async, flush=lambda: None)
    model = torch.nn.Linear(3, 2)
    path = str(tmp_path / "a.pt")
    with smoke.CheckedWrites(ckpt) as writes:
        ckpt.save_async(path, {"params": model, "step": 4})
        ckpt.save_async(path, {"params": model, "step": 9})
        with torch.no_grad():
            model.weight[1, 2] = float("nan")
        with pytest.raises(AssertionError, match="non-finite weights"):
            ckpt.save_async(path, {"params": model, "step": 12})
    assert ckpt.save_async is save_async  # unwrapped on exit
    assert written == [path, path] and writes.writes == [(path, 4), (path, 9)]
    assert writes.steps(path) == [4, 9] and writes.steps(str(tmp_path / "b.pt")) == []
    assert writes.bytes_written() == 2 * os.path.getsize(path)
    assert smoke.nonfinite(dict(model.named_parameters())) == ["weight"]
    assert smoke.nonfinite({}) == []


@pytest.mark.parametrize("steps,error", [
    ([9, 16], None),
    ([9, 16, 16], "writes at steps"),   # a faulted attempt wrote
    ([9], "writes at steps"),
    ([], "writes at steps"),
])
def test_check_writes_one_per_kept_interval(smoke, steps, error):
    """A task's writes are exactly one at the end of each interval that ran
    to its end: a faulted attempt (no record) that wrote fails."""
    runs = [{"n": 9, "restored": False}, {"n": 7, "restored": True}]
    if error is None:
        smoke.check_writes("sweep-nan", steps, runs, 16)
    else:
        with pytest.raises(AssertionError, match=error):
            smoke.check_writes("sweep-nan", steps, runs, 16)
    with pytest.raises(AssertionError, match="the last at 17"):
        smoke.check_writes("sweep-nan", [9, 16], runs, 17)


def _sweep_events_file(tmp_path, trail):
    from saturn_tpu_torch.utils import metrics

    path = str(tmp_path / "events.jsonl")
    with metrics.scoped(path):
        metrics.event("profile_cache", hit=False, task="sick", size=1, technique="dp")
        metrics.event("solver_tier", tier=2, tier_name="lp_round", n_tasks=13)
        metrics.event("solve", makespan_s=12.0, n_tasks=13)
        for code, batches in trail:
            fields = {"batches": batches} if batches is not None else {"cause": "nonfinite"}
            metrics.event("health", code=code, task="sick", **fields)
        metrics.event("health", code="SAT-H001", task="other", cause="nonfinite")
        metrics.event("task_completed", task="sick")
    return path


GOOD_TRAIL = [("SAT-H001", None), ("SAT-H003", None), ("SAT-H001", None),
              ("SAT-H010", [12]), ("SAT-H003", None)]


@pytest.mark.parametrize("trail,error", [
    (GOOD_TRAIL, None),
    (GOOD_TRAIL[:3], "guardian trail"),
    (GOOD_TRAIL[:3] + [("SAT-H010", [11])] + GOOD_TRAIL[4:], "guardian trail"),
])
def test_sweep_events_read_back(smoke, tmp_path, trail, error):
    """The sweep's metrics file, read back through the port's reader: the
    kinds the phase needs, and the faulting task's guardian trail."""
    path = _sweep_events_file(tmp_path, trail)
    if error is None:
        by_kind = smoke.sweep_events(path, "sick", 12)
        assert by_kind["solver_tier"][0]["tier"] == 2 and len(by_kind["health"]) == 6
    else:
        with pytest.raises(AssertionError, match=error):
            smoke.sweep_events(path, "sick", 12)


# ------------------------------------------------------------- phase 7
def _payload(seed=0):
    """A small GPT-2-shaped checkpoint payload: a module's and an AdamW's
    state dicts after one step, and the step count."""
    import torch

    g = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(6, 4), torch.nn.Linear(4, 3))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    model(torch.randn(5, 6, generator=g)).square().sum().backward()
    opt.step()
    return {"params": model.state_dict(), "opt_state": opt.state_dict(), "step": 16}


def _plant(payload, fault):
    import torch

    if fault == "a parameter off by one ulp":
        w = payload["params"]["1.weight"]
        w[0, 0] = torch.nextafter(w[0, 0], torch.tensor(float("inf")))
    elif fault == "a second moment off by one ulp":
        v = payload["opt_state"]["state"][0]["exp_avg_sq"]
        v[1, 2] = torch.nextafter(v[1, 2], torch.tensor(0.0))
    elif fault == "the step":
        payload["step"] = 19
    elif fault == "an optimizer step count":
        payload["opt_state"]["state"][2]["step"] += 1
    elif fault == "a missing moment entry":
        del payload["opt_state"]["state"][3]
    return payload


@pytest.mark.parametrize("fault,error", [
    (None, None),
    ("a parameter off by one ulp", r"params\[1.weight\] differs"),
    ("a second moment off by one ulp", r"opt_state\[0\]\[exp_avg_sq\] differs"),
    ("the step", "step 19, want 16"),
    ("an optimizer step count", r"opt_state\[2\]\[step\] differs"),
    ("a missing moment entry", "different entries"),
])
def test_check_same_state_is_bitwise(smoke, fault, error):
    """The kill chain's final checkpoint against the reference run's: any
    difference, one ulp included, fails."""
    want, got = _payload(), _plant(_payload(), fault)
    if error is None:
        smoke.check_same_state("kill-lr0", want, got)
    else:
        with pytest.raises(AssertionError, match=error):
            smoke.check_same_state("kill-lr0", want, got)


@pytest.mark.parametrize("progress,error", [
    ({"kill-lr0": 16, "kill-lr1": 16}, None),
    ({"kill-lr0": 22, "kill-lr1": 16}, "journaled progress"),  # a lost interval counted twice
    ({"kill-lr0": 10, "kill-lr1": 16}, "journaled progress"),  # a lost interval not counted
    ({"kill-lr1": 16}, "journaled progress"),
])
def test_check_progress_counts_each_batch_once(smoke, progress, error):
    want = {"kill-lr0": 16, "kill-lr1": 16}
    if error is None:
        smoke.check_progress(progress, want)
    else:
        with pytest.raises(AssertionError, match=error):
            smoke.check_progress(progress, want)


@pytest.mark.parametrize("after,error", [
    (2**30, None),
    (2**30 + 256 * 2**20, None),
    (2**30 + 256 * 2**20 + 1, "after the kill"),
    (7 * 2**30, "after the kill"),  # a killed incarnation's train states still held
])
def test_check_memory_after_a_kill(smoke, after, error):
    if error is None:
        smoke.check_memory("after the kill at mid-fsync", after, 2**30)
    else:
        with pytest.raises(AssertionError, match=error):
            smoke.check_memory("after the kill at mid-fsync", after, 2**30)


def _kill_chain_journal(root, fault=None):
    """A three-incarnation journal as phase 7 leaves it, with ``fault``."""
    from saturn_tpu_torch.durability import Journal
    from saturn_tpu_torch.resilience import CrashInjector, SimulatedKill

    kinds = ("plan_commit", "task_progress", "ckpt_published", "interval_commit",
             "task_completed")
    for n in range(3):
        inj = CrashInjector("mid-fsync", hit=2) if n == 0 else None
        j = Journal(root, barrier=inj.barrier if inj else None)
        j.log("recovery")
        for kind in kinds:
            if kind != fault:
                j.append(kind, task="kill-lr0")
        try:
            j.commit()
        except SimulatedKill:
            continue
        j.close()
    if fault == "no sidecar":
        for name in os.listdir(root):
            if ".corrupt" in name:
                os.unlink(os.path.join(root, name))
    if fault == "a seq gap":
        seg = os.path.join(root, "wal-000003.jsonl")
        with open(seg, "rb") as f:
            lines = f.read().splitlines(keepends=True)
        with open(seg, "wb") as f:
            f.writelines(lines[:1] + lines[2:])


@pytest.mark.parametrize("fault,error", [
    (None, None),
    ("task_completed", "missing"),
    ("no sidecar", "no .corrupt sidecar"),
    ("a seq gap", "corrupt or torn"),
])
def test_check_kill_journal(smoke, tmp_path, fault, error):
    root = str(tmp_path / "B")
    _kill_chain_journal(root, fault)
    if error is None:
        kinds = smoke.check_kill_journal(root, 3)
        assert kinds["recovery"] == 3
        with pytest.raises(AssertionError, match="want 4 recovery records"):
            smoke.check_kill_journal(root, 4)
    else:
        with pytest.raises(Exception, match=error):
            smoke.check_kill_journal(root, 3)


def test_call_times_wraps_and_restores(smoke):
    holder = SimpleNamespace(f=lambda x: x + 1)
    f = holder.f
    with smoke.CallTimes(f=(holder, "f")) as timer:
        assert holder.f(1) == 2 and holder.f(2) == 3
        assert holder.f is not f
    assert holder.f is f and len(timer.seconds["f"]) == 2


# ------------------------------------------------------------------ phase 8
FREE_B = """               total        used        free      shared  buff/cache   available
Mem:     103079215104  4294967296 96636764160     1048576  2147483648 98784247808
Swap:               0           0           0
"""


def test_host_facts_reads_free_nproc_and_df(smoke):
    facts = smoke.host_facts(FREE_B, "8\n", "       Avail\n 812345678901\n")
    assert facts == {"mem_total": 103079215104, "mem_available": 98784247808, "cores": 8,
                     "disk_free": 812345678901}


@pytest.mark.parametrize("mem_gib,disk_gb,layers,why", [
    (120, 200, 28, None),
    (92, 200, 24, "host memory"),
    (120, 60, 24, "disk"),
    (92, 60, 24, "host memory available.*disk"),
])
def test_gptj_depth_cuts_depth_only_where_the_host_cannot_hold_it(smoke, mem_gib, disk_gb,
                                                                  layers, why):
    got, cut = smoke.gptj_depth({"mem_available": mem_gib * 2**30, "disk_free": disk_gb * 1e9})
    assert got == layers
    assert (cut is None) if why is None else re.search(why, cut)


def test_split_summary_lines_and_medians(smoke):
    recs = [dict(step=i + 1, h2d_s=0.5 + i, compute_s=0.2, d2h_s=0.4, update_s=3.0 + i,
                 step_s=4.2 + 2 * i, h2d_bytes=23_400_000_000, d2h_bytes=23_400_000_000)
            for i in range(3)]
    out = smoke.split_summary(recs)
    assert out["steps"] == 3 and out["median"]["h2d_s"] == 1.5 and out["median"]["update_s"] == 4.0
    assert out["lines"][0] == ("step 1: host->card 0.500s (23.40 GB), compute 0.200s, "
                               "card->host 0.400s (23.40 GB), host update 3.000s, step 4.200s")
    assert smoke.split_summary([])["median"]["step_s"] is None


@pytest.mark.parametrize("recompute,fwd", [(True, 2 * 12 * 4), (False, 12 * 4)])
def test_offload_launches_count_the_recomputed_forward(smoke, recompute, fwd):
    want = smoke.want_offload_launches(recompute, 4)
    assert want == {"flash_fwd": fwd, "flash_dq": 48, "flash_dkv": 48,
                    "ce_fwd": 0, "ce_dx": 0, "ce_dw": 0}


def test_technique_searches_sees_each_instance_once(smoke):
    from saturn_tpu_torch.parallel.dp import DataParallel
    from saturn_tpu_torch.parallel.offload import HostOffload
    from saturn_tpu_torch.parallel.spmd_base import SPMDTechnique

    orig = SPMDTechnique.search
    dp, off = DataParallel(), HostOffload()
    with smoke.TechniqueSearches() as seen:
        for tech in (dp, off, dp):
            assert tech.search(SimpleNamespace(name="t"), ["a", "b"], 0) == (None, None)
    assert seen.seen == [dp, off] and seen.named("offload") is off
    assert SPMDTechnique.search is orig


def test_offload_launches_scale_with_the_layers(smoke):
    """GPT-J-6B at 4 layers (phase 8c, the 8b-2 orchestrate): one launch of
    each flash kernel per layer and step, the forward twice in stream mode."""
    assert smoke.want_offload_launches(True, 4, 4)["flash_fwd"] == 32
    assert smoke.want_offload_launches(False, 4, 4) == {
        "flash_fwd": 16, "flash_dq": 16, "flash_dkv": 16, "ce_fwd": 0, "ce_dx": 0, "ce_dw": 0}


def test_bytes_written_counts_write_calls(smoke, tmp_path):
    before = smoke.bytes_written()
    (tmp_path / "x.bin").write_bytes(b"\0" * (1 << 20))
    assert smoke.bytes_written() - before >= 1 << 20


def test_bundle_steps_offload_matches_dp_over_the_logits(smoke, tmp_path):
    """Phase 8c's stepping helper on the CPU at test size: offload bulk and
    stream follow dp over the logits (the repo's trajectory tolerance) and
    write no checkpoint."""
    import numpy as np
    import torch

    import saturn_tpu_torch as sat
    from saturn_tpu_torch.data.lm_dataset import make_lm_dataset
    from saturn_tpu_torch.models.gpt2 import build_gpt2

    task = sat.Task(
        get_model=lambda **kw: build_gpt2("gptj-test-tiny", **{"dtype": torch.float32, **kw}),
        get_dataloader=lambda: make_lm_dataset(context_length=64, batch_size=4, vocab_size=256,
                                               n_tokens=64 * 4 * 8),
        loss_fn=smoke.untagged_loss, hparams=sat.HParams(lr=1e-3, batch_count=4),
        name="parity", save_dir=str(tmp_path))
    cpu = torch.device("cpu")
    runs = {label: smoke.bundle_steps(cls(), task, config, cpu, 3)
            for label, cls, config, _ in smoke.parity_programs()}
    for label in ("offload-stream", "offload-bulk"):
        np.testing.assert_allclose(runs[label], runs["dp-logits"], rtol=smoke.OFFLOAD_REL)
    assert len(runs["dp-logits"]) == 3 and np.isfinite(runs["dp-logits"]).all()
    assert not task.has_ckpt()
