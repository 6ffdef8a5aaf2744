"""Experiment logging: stdout and a log file, one file per statistic, and tensorboard if present.

Port of ``safe_control_gym_tpu/utils/logging.py``: ``StdoutLogger`` (stream and
``std_out.txt``), ``FileLogger`` (``logs/<name>.log``, one ``step value`` line
per call, truncated past a step on resume) and ``ExperimentLogger``, which
buffers scalars, writes them to both and prints them as an ASCII table. The
tensorboard writer is used where ``torch.utils.tensorboard`` imports, and
skipped where it does not.

    logger = ExperimentLogger('temp/run')
    logger.add_scalar('ppo/policy_loss', 0.1, step=9600)
    logger.dump_scalars()
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Any, Dict

import numpy as np

__all__ = ['StdoutLogger', 'FileLogger', 'ExperimentLogger']


class StdoutLogger:
    """Print to stdout and, with ``log_dir``, to ``<log_dir>/std_out.txt``."""

    def __init__(self, logger_name='', log_dir='', level=logging.INFO):
        logger = logging.getLogger(logger_name or __name__)
        logger.setLevel(level)
        logger.handlers = []
        formatter = logging.Formatter('%(asctime)s : %(message)s')
        stream_handler = logging.StreamHandler(sys.stdout)
        stream_handler.setFormatter(formatter)
        logger.addHandler(stream_handler)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            file_handler = logging.FileHandler(os.path.join(log_dir, 'std_out.txt'))
            file_handler.setFormatter(formatter)
            logger.addHandler(file_handler)
        logger.propagate = False
        self.logger = logger

    def info(self, msg):
        self.logger.info(msg)

    def close(self):
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)


class FileLogger:
    """Each statistic to its own ``<log_dir>/logs/<name>.log``."""

    def __init__(self, log_dir):
        self.log_dir = os.path.join(log_dir, 'logs')
        os.makedirs(self.log_dir, exist_ok=True)
        self.files: Dict[str, Any] = {}

    def _file(self, name):
        if name not in self.files:
            path = os.path.join(self.log_dir, name.replace('/', '_') + '.log')
            self.files[name] = open(path, 'a')
        return self.files[name]

    def log(self, name, value, step):
        f = self._file(name)
        f.write(f'{step} {value}\n')
        f.flush()

    def restore(self, step):
        """Drop every logged line past ``step`` (a resumed run)."""
        for fname in os.listdir(self.log_dir):
            if not fname.endswith('.log'):
                continue
            path = os.path.join(self.log_dir, fname)
            with open(path, 'r') as f:
                lines = f.readlines()
            kept = [ln for ln in lines if ln.strip() and int(float(ln.split()[0])) <= step]
            with open(path, 'w') as f:
                f.writelines(kept)

    def close(self):
        for f in self.files.values():
            f.close()
        self.files = {}


class ExperimentLogger:
    """Stdout, per-statistic files and (optionally) tensorboard, with
    buffered scalars printed as a table by ``dump_scalars``."""

    def __init__(self, log_dir, log_file_out=True, use_tensorboard=False):
        self.log_dir = log_dir or '.'
        os.makedirs(self.log_dir, exist_ok=True)
        self.std_logger = StdoutLogger(logger_name=f'exp_logger_{id(self)}',
                                       log_dir=self.log_dir if log_file_out else '')
        self.file_logger = FileLogger(self.log_dir)
        self.use_tensorboard = use_tensorboard
        self.tb_writer = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb_writer = SummaryWriter(log_dir=os.path.join(self.log_dir, 'tb'))
            except ImportError:
                self.use_tensorboard = False
        self._buffer: Dict[str, Any] = {}
        self._steps: Dict[str, int] = {}

    def info(self, msg):
        self.std_logger.info(msg)

    def add_scalar(self, name, value, step, store=True, write=True, write_tb=True):
        """Buffer a scalar; write it to its file and to tensorboard."""
        if store:
            self._buffer[name] = value
            self._steps[name] = step
        if write:
            self.file_logger.log(name, value, step)
        if write_tb and self.tb_writer is not None:
            self.tb_writer.add_scalar(name, value, step)

    def add_scalars(self, data: Dict[str, Any], step, prefix=None, **kwargs):
        for k, v in data.items():
            self.add_scalar(f'{prefix}/{k}' if prefix else k, v, step, **kwargs)

    def dump_scalars(self):
        """Print the buffered scalars as an ASCII table and clear the buffer."""
        if not self._buffer:
            return
        width = max(len(k) for k in self._buffer) + 2
        lines = ['-' * (width + 22)]
        for k in sorted(self._buffer):
            v = self._buffer[k]
            vs = f'{v:.6g}' if isinstance(v, (int, float, np.floating)) else str(v)
            lines.append(f'| {k:<{width}}| {vs:<16} |')
        lines.append('-' * (width + 22))
        self.std_logger.info('\n'.join(lines))
        self._buffer = {}
        self._steps = {}

    def load(self, step):
        """Truncate the logs past ``step`` for a resumed run; the tensorboard
        writer restarts with ``purge_step``."""
        self.file_logger.restore(step)
        if self.tb_writer is not None:
            from torch.utils.tensorboard import SummaryWriter
            self.tb_writer.close()
            self.tb_writer = SummaryWriter(log_dir=os.path.join(self.log_dir, 'tb'),
                                           purge_step=step)

    def close(self):
        self.std_logger.close()
        self.file_logger.close()
        if self.tb_writer is not None:
            self.tb_writer.close()
