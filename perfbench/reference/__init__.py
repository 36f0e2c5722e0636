"""Plain float32 references of the served model families, one module per
family (``<family>.py``), found by the configuration's ``family``. They
import nothing of the program."""
