"""Terminal progress bar and task-mapping helpers.

The port's own copy of ``scalerl_tpu/utils/progress.py`` (mmcv-style
``ProgressBar``, ``track_progress``, ``track_iter_progress`` and
``track_parallel_progress``).
"""

from __future__ import annotations

import sys
import time
from multiprocessing import Pool
from shutil import get_terminal_size
from typing import Any, Callable, Iterable, List, Optional, Sequence


class ProgressBar:
    def __init__(self, task_num: int = 0, bar_width: int = 50, start: bool = True, file=sys.stdout) -> None:
        self.task_num = task_num
        self.bar_width = bar_width
        self.completed = 0
        self.file = file
        if start:
            self.start()

    @property
    def terminal_width(self) -> int:
        return get_terminal_size().columns

    def start(self) -> None:
        if self.task_num > 0:
            self.file.write(f"[{' ' * self.bar_width}] 0/{self.task_num}, elapsed: 0s, ETA:")
        else:
            self.file.write("completed: 0, elapsed: 0s")
        self.file.flush()
        self.start_time = time.time()

    def update(self, num_tasks: int = 1) -> None:
        self.completed += num_tasks
        elapsed = time.time() - self.start_time or 1e-8
        fps = self.completed / elapsed
        if self.task_num > 0:
            pct = self.completed / float(self.task_num)
            eta = int(elapsed * (1 - pct) / max(pct, 1e-8) + 0.5)
            msg = (
                f"\r[{{}}] {self.completed}/{self.task_num}, {fps:.1f} task/s, "
                f"elapsed: {int(elapsed + 0.5)}s, ETA: {eta:5}s"
            )
            bar_width = min(self.bar_width, int(self.terminal_width - len(msg)) + 2, int(self.terminal_width * 0.6))
            bar_width = max(2, bar_width)
            mark_width = int(bar_width * pct)
            bar_chars = ">" * mark_width + " " * (bar_width - mark_width)
            self.file.write(msg.format(bar_chars))
        else:
            self.file.write(
                f"completed: {self.completed}, elapsed: {int(elapsed + 0.5)}s, {fps:.1f} tasks/s"
            )
        self.file.flush()


def track_progress(func: Callable, tasks: Sequence[Any], bar_width: int = 50, file=sys.stdout, **kwargs) -> List[Any]:
    """Map ``func`` over ``tasks`` with a progress bar."""
    prog_bar = ProgressBar(len(tasks), bar_width, file=file)
    results = []
    for task in tasks:
        results.append(func(task, **kwargs))
        prog_bar.update()
    file.write("\n")
    return results


def track_iter_progress(tasks: Sequence[Any], bar_width: int = 50, file=sys.stdout) -> Iterable[Any]:
    prog_bar = ProgressBar(len(tasks), bar_width, file=file)
    for task in tasks:
        yield task
        prog_bar.update()
    file.write("\n")


def track_parallel_progress(
    func: Callable,
    tasks: Sequence[Any],
    nproc: int,
    initializer: Optional[Callable] = None,
    initargs: tuple = (),
    bar_width: int = 50,
    chunksize: int = 1,
    keep_order: bool = True,
    file=sys.stdout,
) -> List[Any]:
    """Parallel map with a progress bar (process pool)."""
    pool = Pool(nproc, initializer, initargs)
    prog_bar = ProgressBar(len(tasks), bar_width, file=file)
    results = []
    gen = pool.imap(func, tasks, chunksize) if keep_order else pool.imap_unordered(func, tasks, chunksize)
    for result in gen:
        results.append(result)
        prog_bar.update()
    file.write("\n")
    pool.close()
    pool.join()
    return results
