"""The benchmark's plain reference render (see render.py)."""
