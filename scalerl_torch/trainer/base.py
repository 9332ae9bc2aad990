"""Trainer base: the run directory, the loggers, the telemetry export and
resume checkpoints.

Port of ``scalerl_tpu/trainer/base.py``.  A run writes under
``work_dir/project/env_id/algo_name/run_name/`` (``tb_log``, ``text_log``,
``model_dir``); ``--resume <run dir>`` continues in that directory, so the
logger's event files append and ``model_dir/resume`` is found.  Only the
main process (``utils.logging.process_index() == 0``) writes.  The logger
is the one ``logger_backend`` names; ``telemetry_interval_s > 0`` starts the
export loop (``telemetry.jsonl`` and ``metrics.prom`` under
``<run dir>/telemetry`` unless ``telemetry_dir`` says otherwise) and turns
the trainers' registry writes on (``self._instrument``).

Besides the logger, :meth:`BaseTrainer.log` keeps what a trainer logged in
:attr:`BaseTrainer.log_history`, in order, for callers that read a run's
curve without an event-file reader.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

from scalerl_torch.config import RLArguments
from scalerl_torch.utils.loggers import BaseLogger, make_logger
from scalerl_torch.utils.logging import get_logger, process_index


class BaseTrainer:
    def __init__(self, args: RLArguments, run_name: Optional[str] = None) -> None:
        args.validate()
        self.args = args
        self.is_main_process = process_index() == 0
        self.resuming = bool(args.resume)
        if self.resuming:
            root = args.resume.rstrip("/")
            run_name = os.path.basename(root)
        else:
            stamp = time.strftime("%Y%m%d_%H%M%S")
            run_name = run_name or f"{args.algo_name}_{args.seed}_{stamp}"
            root = os.path.join(args.work_dir, args.project, args.env_id, args.algo_name,
                                run_name)
        self.run_name = run_name
        self.work_dir = root
        self.tb_log_dir = os.path.join(root, "tb_log")
        self.text_log_dir = os.path.join(root, "text_log")
        self.model_save_dir = os.path.join(root, "model_dir")
        if self.is_main_process:
            for d in (self.tb_log_dir, self.text_log_dir, self.model_save_dir):
                os.makedirs(d, exist_ok=True)

        self.text_logger = get_logger(
            "scalerl_torch",
            log_file=os.path.join(self.text_log_dir, f"{run_name}.log")
            if self.is_main_process else None,
        )
        if self.is_main_process and args.logger_backend != "none":
            self.logger: BaseLogger = make_logger(
                args.logger_backend,
                self.tb_log_dir,
                project=args.project,
                name=run_name,
                config=vars(args),
                train_interval=args.logger_frequency,
                update_interval=args.logger_frequency,
            )
        else:
            self.logger = make_logger("none", self.tb_log_dir)
        # (env step, "train" | "eval", host metrics), in the order logged
        self.log_history: List[Tuple[int, str, Dict[str, float]]] = []

        self.telemetry_export = None
        interval_s = float(args.telemetry_interval_s or 0.0)
        self._instrument = interval_s > 0
        if self.is_main_process and interval_s > 0:
            from scalerl_torch.runtime.telemetry import TelemetryExportLoop, get_registry

            out_dir = args.telemetry_dir or os.path.join(root, "telemetry")
            self.telemetry_export = TelemetryExportLoop(out_dir, interval_s=interval_s).start()
            get_registry().set_gauges({"seed": float(args.seed)}, prefix="run.")

    def log(self, step: int, kind: str, metrics: Dict[str, float]) -> None:
        """Record host metrics in :attr:`log_history`."""
        self.log_history.append((step, kind, dict(metrics)))

    # -- resume checkpoints ---------------------------------------------
    @property
    def resume_ckpt_path(self) -> str:
        return os.path.join(self.model_save_dir, "resume")

    def save_resume_checkpoint(self, state: Any, env_step: int, grad_step: int) -> None:
        """Write everything needed to continue (``state``: a tree of train
        state, replay and counters) and the logger's save markers, from
        which ``restore_data`` recovers the interval gates."""
        if not self.is_main_process:
            return
        from scalerl_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(self.resume_ckpt_path, state, keep_last=self.args.checkpoint_keep_last)
        self.logger.save_data(0, env_step, grad_step)

    def load_resume_checkpoint(self, target: Any) -> Optional[Any]:
        """Restore the resume tree (``target`` gives its structure, dtypes
        and devices) and the logger's counters; None without a checkpoint,
        unless ``--resume`` asked for one: then a ``FileNotFoundError``,
        because training from step 0 into the old run directory would pass
        for its continuation."""
        if not os.path.exists(self.resume_ckpt_path):
            if self.resuming:
                raise FileNotFoundError(
                    f"--resume={self.args.resume}: no resume checkpoint at "
                    f"{self.resume_ckpt_path} (pass the run directory that "
                    "holds model_dir/resume, written at save_frequency)"
                )
            return None
        from scalerl_torch.utils.checkpoint import load_checkpoint

        state = load_checkpoint(self.resume_ckpt_path, target)
        self.logger.restore_data()
        return state

    def close(self) -> None:
        if self.telemetry_export is not None:
            self.telemetry_export.stop()  # a last flush: the files hold the end state
            self.telemetry_export = None
        self.logger.close()
