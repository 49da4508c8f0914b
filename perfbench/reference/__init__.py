"""The benchmark's plain reference: the frames the program must produce,
worked out again in plain PyTorch from the scene file and the camera
alone (``render.py``), one module a kind of kept frame (``voxel.py``,
``guided.py``).  It imports nothing of the program."""
