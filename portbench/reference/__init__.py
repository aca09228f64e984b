"""The plain reference that decides a run's ``correct``: Spinner in plain
PyTorch and NumPy, with its own copy of the threefry streams.  It imports
nothing of the program under test."""
