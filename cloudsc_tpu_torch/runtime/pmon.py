"""Energy/power monitoring — the EC_PMON analogue, with the card as source.

Counterpart of `cloudsc_tpu/runtime/pmon.py`. The reference samples Cray
pm_counters during the block loop when the EC_PMON env var is set (ref:
src/common/module/ec_pmon_mod.F90:14-57, cloudsc_driver_mod.F90:170-178).
For a CUDA device the source is NVML, the driver's own library
(`libnvidia-ml.so.1`, bound with ctypes; no package):
`nvmlDeviceGetTotalEnergyConsumption` (millijoules since the driver loaded)
and `nvmlDeviceGetPowerUsage` (milliwatts) of that device. On the host it
reads the Cray paths when present and falls back to Linux RAPL
(/sys/class/powercap). Disabled (returning None) unless EC_PMON is set,
matching the reference. With EC_PMON set, a CUDA device and no NVML it
raises: the card's energy is never replaced by the host's.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

_CRAY_ENERGY = Path("/sys/cray/pm_counters/energy")
_CRAY_POWER = Path("/sys/cray/pm_counters/power")
_RAPL_GLOB = "intel-rapl:*"
_RAPL_ROOT = Path("/sys/class/powercap")
_NVML_NAME = "libnvidia-ml.so.1"


def enabled() -> bool:
    return bool(os.environ.get("EC_PMON"))


def _read_int(path: Path):
    try:
        return int(path.read_text().split()[0])
    except (OSError, ValueError, IndexError):
        return None


def load_nvml():
    """The NVML library, initialised; raises RuntimeError where the driver's
    library is missing or does not start."""
    try:
        lib = ctypes.CDLL(_NVML_NAME)
    except OSError as e:
        raise RuntimeError(f"EC_PMON on a CUDA device needs NVML "
                           f"({_NVML_NAME}): {e}") from None
    u32, u64, vp = ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_void_p
    for name, args in (
            ("nvmlInit_v2", []),
            ("nvmlDeviceGetHandleByIndex_v2", [u32, ctypes.POINTER(vp)]),
            ("nvmlDeviceGetHandleByPciBusId_v2",
             [ctypes.c_char_p, ctypes.POINTER(vp)]),
            ("nvmlDeviceGetTotalEnergyConsumption", [vp, ctypes.POINTER(u64)]),
            ("nvmlDeviceGetPowerUsage", [vp, ctypes.POINTER(u32)])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    rc = lib.nvmlInit_v2()
    if rc != 0:
        raise RuntimeError(f"nvmlInit_v2 failed: NVML error {rc}")
    return lib


def _pci_bus_id(index: int) -> str | None:
    """The PCI bus id of CUDA device `index`, which NVML also knows the
    card by (its own index ignores CUDA_VISIBLE_DEVICES)."""
    import torch

    props = torch.cuda.get_device_properties(index)
    if not hasattr(props, "pci_bus_id"):
        return None
    return (f"{getattr(props, 'pci_domain_id', 0):08x}:"
            f"{props.pci_bus_id:02x}:{props.pci_device_id:02x}.0")


class NvmlSource:
    """(energy_joules, power_watts) of one card, from NVML. `lib` is the
    library object (`load_nvml()` if None); `pci_bus_id` finds the card
    where given and known to NVML, else NVML's own `index`."""

    def __init__(self, index: int = 0, lib=None, pci_bus_id: str | None = None):
        self.lib = load_nvml() if lib is None else lib
        self.handle = ctypes.c_void_p()
        rc = -1
        if pci_bus_id is not None:
            rc = self.lib.nvmlDeviceGetHandleByPciBusId_v2(
                pci_bus_id.encode(), ctypes.byref(self.handle))
        if rc != 0:  # no bus id, or NVML does not know it in this form
            rc = self.lib.nvmlDeviceGetHandleByIndex_v2(
                index, ctypes.byref(self.handle))
        if rc != 0:
            raise RuntimeError(f"nvmlDeviceGetHandleByIndex_v2({index}) "
                               f"failed: NVML error {rc}")

    def energy_power(self):
        mj, mw = ctypes.c_ulonglong(), ctypes.c_uint()
        rc = self.lib.nvmlDeviceGetTotalEnergyConsumption(
            self.handle, ctypes.byref(mj))
        if rc != 0:
            raise RuntimeError(f"nvmlDeviceGetTotalEnergyConsumption failed: "
                               f"NVML error {rc}")
        rc = self.lib.nvmlDeviceGetPowerUsage(self.handle, ctypes.byref(mw))
        if rc != 0:
            raise RuntimeError(f"nvmlDeviceGetPowerUsage failed: NVML error "
                               f"{rc}")
        return mj.value * 1e-3, mw.value * 1e-3


def _host_energy_power():
    if _CRAY_ENERGY.exists():
        e = _read_int(_CRAY_ENERGY)
        p = _read_int(_CRAY_POWER)
        if e is not None:
            return float(e), float(p or 0)
    if _RAPL_ROOT.is_dir():
        total_uj = 0
        found = False
        for pkg in sorted(_RAPL_ROOT.glob(_RAPL_GLOB)):
            v = _read_int(pkg / "energy_uj")
            if v is not None:
                total_uj += v
                found = True
        if found:
            return total_uj * 1e-6, 0.0
    return None


def energy_power(source: NvmlSource | None = None):
    """(energy_joules, power_watts) or None when disabled/unsupported: the
    card's from `source`, the host's counters without one."""
    if not enabled():
        return None
    if source is not None:
        return source.energy_power()
    return _host_energy_power()


class EnergySampler:
    """Start/stop sampler printing the reference-style energy line. For a
    CUDA `device` it samples that card through NVML (and raises when EC_PMON
    is set and NVML is missing); for the host, the Cray/RAPL counters."""

    def __init__(self, device=None, source: NvmlSource | None = None):
        self._start = None
        self._source = source
        if source is None and enabled() and device is not None:
            import torch

            device = torch.device(device)
            if device.type == "cuda":
                index = device.index if device.index is not None \
                    else torch.cuda.current_device()
                self._source = NvmlSource(index,
                                          pci_bus_id=_pci_bus_id(index))

    def start(self):
        self._start = energy_power(self._source)

    def stop_and_report(self, prefix: str = " ") -> str | None:
        if self._start is None:
            return None
        now = energy_power(self._source)
        if now is None:
            return None
        de = now[0] - self._start[0]
        return f"{prefix}EC_PMON: energy delta {de:.1f} J, power {now[1]:.0f} W"
