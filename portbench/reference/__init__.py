"""The plain reference renderer that decides ``correct``: plain PyTorch
and numpy, brute force, importing nothing of the program.  It works again
from the plain scene data everything the program derives (the leaves'
blocks, the kd leaf-cell gates, the bounding spheres, the camera) and
traces every ray against every leaf.  ``render.render`` is its entry."""
