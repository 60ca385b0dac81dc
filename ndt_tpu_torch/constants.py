"""Numeric conventions, shared with the JAX package (which holds the values
and their sources in the C reference)."""

from ndt_tpu.constants import (BIG, EPSILON, EYE_OFFSET,  # noqa: F401
                               MIN_PIXEL_FRAC, SPECULAR_POWER)
