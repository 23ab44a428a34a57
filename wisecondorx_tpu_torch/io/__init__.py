"""File formats of the port: sample and reference ``.npz`` (npz.py) and
aligned reads (bam.py)."""
