"""The BED and statistics writers of predict (tables.py)."""
