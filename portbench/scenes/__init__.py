"""Scene generators, one module per kind of configuration: each module's
``Frames(config, seed).frame(k)`` is frame k's plain scene data."""
