"""Numeric conventions of the renderer, with their sources in the C
reference (the same values as ``ndt_tpu/constants.py``).

EPSILON = 1e-4 (vectNd.h:25) is the minimum hit distance, the bounding
pad, the end-test slack, the shadow-ray point match and the unitize guard.
"""

EPSILON = 1e-4
EPSILON2 = EPSILON * EPSILON

# get_ray_color() stops recursing when the accumulated contribution of a
# branch falls below 1/512 (ndt.c:336-337).
MIN_PIXEL_FRAC = 1.0 / 512.0

# Adaptive per-pixel sampling bounds (ndt.c:474-476).
MAX_SAMPLES = 10000
MAX_SAMPLE_DIFF = 1.0 / 256.0

# Stereo eye separation (camera.h:11).
EYE_OFFSET = 0.125

# Specular exponent (ndt.c:300).
SPECULAR_POWER = 50.0

# Large-but-finite stand-in for "no hit" distances on the device.
BIG = 1e30
