"""Append-only CSV output with the stdlib ``csv`` module."""

import csv
import os


def append_csv_rows(path, rows, columns):
    """Append dict ``rows`` to the CSV at ``path``, writing the header only
    when the file does not exist yet (the layout of pandas'
    ``to_csv(mode="a", header=not exists)``, which earlier versions used)."""
    header = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(columns), lineterminator="\n")
        if header:
            writer.writeheader()
        writer.writerows(rows)
