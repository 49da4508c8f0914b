"""The benchmark's plain reference: the frames the program must produce,
worked out again in plain PyTorch from the scene file and the camera
alone.  It imports nothing of the program."""
