"""The plain reference of `correct`: a path tracer and SVGF in plain
PyTorch that imports nothing of the program and works out again every
table the renderer derives from the scene."""
