"""Index-of-refraction databases (port of mitsuba_tpu/bsdf/ior.py).

* Named dielectrics: reference src/bsdfs/ior.h iorData (values from
  Hecht, Optics, 4th ed.)
* Conductors: RGB-projected eta/k spectra in the port's own
  mitsuba_tpu_torch/data/conductor_ior_rgb.npz (a byte copy of the JAX
  package's table, derived from the public luxpop/Palik measurement data
  the reference ships as data/ior/*.spd).
"""

from __future__ import annotations

import os

import numpy as np

DIELECTRIC_IOR = {
    "vacuum": 1.0,
    "helium": 1.000036,
    "hydrogen": 1.000132,
    "air": 1.000277,
    "carbon dioxide": 1.00045,
    "water": 1.3330,
    "acetone": 1.36,
    "ethanol": 1.361,
    "carbon tetrachloride": 1.461,
    "glycerol": 1.4729,
    "benzene": 1.501,
    "silicone oil": 1.52045,
    "bromine": 1.661,
    "water ice": 1.31,
    "fused quartz": 1.458,
    "pyrex": 1.470,
    "acrylic glass": 1.49,
    "polypropylene": 1.49,
    "bk7": 1.5046,
    "sodium chloride": 1.544,
    "amber": 1.55,
    "pet": 1.5750,
    "diamond": 2.419,
}

# the port's own copy of the conductor table
CONDUCTOR_TABLE = os.path.join(os.path.dirname(__file__), "..", "data", "conductor_ior_rgb.npz")
_CONDUCTORS = None


def _conductors():
    global _CONDUCTORS
    if _CONDUCTORS is None:
        data = np.load(CONDUCTOR_TABLE)
        names = [str(n) for n in data["names"]]
        _CONDUCTORS = {
            n: (data["eta"][i], data["k"][i]) for i, n in enumerate(names)
        }
        # perfect mirror pseudo-material (reference conductor.cpp "none")
        _CONDUCTORS["none"] = (
            np.zeros(3, np.float32),
            np.full(3, 1e7, np.float32),
        )
    return _CONDUCTORS


def lookup_dielectric(name_or_value) -> float:
    if isinstance(name_or_value, (int, float)):
        return float(name_or_value)
    s = str(name_or_value).strip().lower()
    try:
        return float(s)
    except ValueError:
        pass
    if s in DIELECTRIC_IOR:
        return DIELECTRIC_IOR[s]
    raise KeyError(f"unknown dielectric material '{name_or_value}'")


def lookup_conductor(material: str):
    """Return (eta_rgb, k_rgb) for a named conductor, e.g. 'Cu', 'Au'."""
    db = _conductors()
    if material in db:
        return db[material]
    raise KeyError(
        f"unknown conductor material '{material}' "
        f"(known: {', '.join(sorted(db))})"
    )
