"""The 15 SEC2 prime curves.

Counterpart of the JAX package's ``curves/sec2.py:26-70``: the eight curves
its reference backs with constant-time code (``FIAT_TIER``) and the seven
smaller ones (``SMALL_TIER``), all on the same batched engine. The JAX
package picks a field engine per prime (``Field.solinas_ok``); the port's
``field_sec2.Field`` serves every prime with one format, so there is no
choice to make. A curve's ``scalar`` is the field of its group order
(JAX ``curves/sec2.py:56``), ``field_sec2.field_of`` of the order, named
after the curve with the suffix _n.
"""

from __future__ import annotations

from ..field_sec2 import Field, field_of
from ..params.sec2_params import CURVES
from .weierstrass import WeierstrassCurveSpec

_cache: dict = {}

FIAT_TIER = [
    "p192k1", "p192r1", "p224k1", "p224r1",
    "p256k1", "p256r1", "p384r1", "p521r1",
]
SMALL_TIER = [
    "p112r1", "p112r2", "p128r1", "p128r2",
    "p160k1", "p160r1", "p160r2",
]
ALL = FIAT_TIER + SMALL_TIER


def get_curve(name: str) -> WeierstrassCurveSpec:
    if name in _cache:
        return _cache[name]
    c = CURVES[name]
    p = c["p"]
    a = c["a"] % p
    shape = "a0" if a == 0 else "am3" if a == p - 3 else "generic"
    spec = WeierstrassCurveSpec(
        name=name, field=Field(name, p), scalar=field_of(c["order"]),
        a=c["a"], b_coeff=c["b"], gx=c["gx"], gy=c["gy"], shape=shape)
    _cache[name] = spec
    return spec


def __getattr__(name: str):
    if name in ALL:
        return get_curve(name)
    raise AttributeError(name)
