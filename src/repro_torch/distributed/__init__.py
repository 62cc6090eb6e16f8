"""The pieces of the reference's ``distributed`` package that the
distributed tile driver (``core/dist_exec.py``) uses."""
