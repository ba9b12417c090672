"""Launching the port across ranks (counterpart of ``repro.launch``):
:mod:`.mesh` builds serving meshes and starts the processes behind
them."""
