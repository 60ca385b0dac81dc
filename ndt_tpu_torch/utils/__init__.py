"""Host-side scene preparation: drand48, Nelder-Mead, bounding spheres and
the C-exact kd leaf cells."""
