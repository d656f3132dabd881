"""Float text files: loss logs and per-image times (JAX counterpart:
``deepfluoro_tpu/utils/io.py``).

File contracts match the reference exactly ('{:.6f}\\n' lines, flushed per
write, append mode on resume): util.py:53-89, train.py:365-367.
"""

from __future__ import annotations


def write_floats_to_txt(file_path: str, floats) -> None:
    with open(file_path, "w") as out:
        for x in floats:
            out.write("{:.6f}\n".format(float(x)))


def read_floats_from_txt(file_path: str):
    with open(file_path) as f:
        return [float(line.strip()) for line in f]


class RunningFloatWriter:
    """Appendable, flushed-per-line float writer (reference util.py:62-89)."""

    def __init__(self, file_path: str, new_file: bool = True):
        self.out = open(file_path, "w" if new_file else "a")

    def write(self, x) -> None:
        self.out.write("{:.6f}\n".format(float(x)))
        self.out.flush()

    def close(self) -> None:
        if self.out:
            self.out.flush()
            self.out.close()
            self.out = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        self.close()
