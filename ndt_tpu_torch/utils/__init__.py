"""Host-side scene preparation (drand48, Nelder-Mead, bounding spheres,
the C-exact kd leaf cells, k-means) and the reference's public matrix and
texture-map libraries (matrix.py, texmap.py)."""
