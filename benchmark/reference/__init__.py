"""The plain reference that decides ``correct``: plain PyTorch, one module
per model family (``<family>.py``), the frontend, the training step's
semantics and accept counting.  It imports nothing of the program and takes
nothing the program made."""
