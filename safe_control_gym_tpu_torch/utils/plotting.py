"""Plotting: load ``logs/*.log`` statistic files, smooth, align and plot runs.

Port of ``safe_control_gym_tpu/utils/plotting.py``: the numpy parts
(``rolling_window``, ``window_func``, ``filter_log_dirs``, ``align_runs``,
``smooth_runs``, ``select_runs``, ``interpolate_runs``, ``load_from_log_file``,
``load_from_logs``, ``get_log_dirs``) as they are, and the plots
(``plot_from_logs``, ``plot_from_tensorboard_log``, ``plot_from_experiments``)
through matplotlib's Agg backend, imported when a plot is made: a machine
without matplotlib reads and smooths logs, and raises ``ImportError`` only
when asked for a plot.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    'rolling_window', 'window_func', 'filter_log_dirs', 'align_runs',
    'smooth_runs', 'select_runs', 'interpolate_runs', 'load_from_log_file',
    'load_from_logs', 'plot_from_logs', 'plot_from_tensorboard_log',
    'plot_from_experiments', 'get_log_dirs',
]


def _plt():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def rolling_window(a, window):
    """Stride-tricked rolling windows."""
    shape = a.shape[:-1] + (a.shape[-1] - window + 1, window)
    strides = a.strides + (a.strides[-1],)
    return np.lib.stride_tricks.as_strided(a, shape=shape, strides=strides)


def window_func(x, y, window, func):
    """Apply func over rolling windows."""
    yw = rolling_window(y, window)
    yw_func = func(yw, axis=-1)
    return x[window - 1:], yw_func


def filter_log_dirs(pattern, negative_pattern=' ', root='./log', **kwargs):
    """Find matching log dirs under root."""
    dirs = [item[0] for item in os.walk(root)]
    leaf_dirs = []
    for i in range(len(dirs)):
        if i + 1 < len(dirs) and dirs[i + 1].startswith(dirs[i]):
            continue
        leaf_dirs.append(dirs[i])
    names = []
    for d in leaf_dirs:
        if pattern in d and negative_pattern not in d:
            names.append(d)
    names.sort()
    return names


def align_runs(xy_list, x_num_max=None):
    """Clip runs to the shortest x-range."""
    x_max = float('inf')
    for x, y in xy_list:
        x_max = min(x_max, len(x))
    if x_num_max:
        x_max = min(x_max, x_num_max)
    return [[x[:int(x_max)], y[:int(x_max)]] for x, y in xy_list]


def smooth_runs(xy_list, window=10):
    """Window-smooth each run."""
    if window <= 1:
        return xy_list
    return [window_func(np.asarray(x), np.asarray(y), window, np.mean)
            for x, y in xy_list]


def select_runs(xy_list, criterion, top_k=0):
    """Keep top-k runs by criterion over y."""
    perf = [criterion(y) for _, y in xy_list]
    top_k_runs = np.argsort(perf)[-top_k:]
    return [xy_list[r] for r in top_k_runs]


def interpolate_runs(xy_list, interp_interval=100):
    """Resample runs onto a common x-grid."""
    x_right = float('inf')
    x_left = -float('inf')
    for x, _ in xy_list:
        x_right = min(x_right, np.max(x))
        x_left = max(x_left, np.min(x))
    x = np.arange(x_left, x_right + 1, interp_interval)
    y = [np.interp(x, np.asarray(xi), np.asarray(yi)) for xi, yi in xy_list]
    return x, np.stack(y)


def load_from_log_file(path):
    """Read one stat's log file -> (xk, x, yk, y)."""
    steps, values = [], []
    with open(path, 'r') as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) >= 2:
                steps.append(float(parts[0]))
                values.append(float(parts[1]))
    name = os.path.splitext(os.path.basename(path))[0]
    return 'step', np.asarray(steps), name, np.asarray(values)


def load_from_logs(log_dir):
    """Load all stat files under <log_dir>/logs."""
    data = {}
    logs_dir = os.path.join(log_dir, 'logs')
    root = logs_dir if os.path.isdir(logs_dir) else log_dir
    for fname in sorted(os.listdir(root)):
        if fname.endswith('.log'):
            xk, x, yk, y = load_from_log_file(os.path.join(root, fname))
            data[yk] = (xk, x, yk, y)
    return data


def plot_from_logs(src_dir, out_dir, window=None, keys=None):
    """Generate plots per stat from a log dir."""
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    data = load_from_logs(src_dir)
    for k, (xk, x, yk, y) in data.items():
        if keys and k not in keys:
            continue
        if window and len(y) > window:
            x, y = window_func(x, y, window, np.mean)
        plt.figure()
        plt.plot(x, y)
        plt.xlabel(xk)
        plt.ylabel(yk)
        plt.title(k)
        out_path = os.path.join(out_dir, k.replace('/', '_') + '.png')
        plt.savefig(out_path)
        plt.close()


def plot_from_tensorboard_log(src_dir, out_dir, window=None, keys=None,
                              xlabel='step'):
    """Plot scalars from tensorboard event files."""
    try:
        from tensorboard.backend.event_processing.event_accumulator import \
            EventAccumulator
    except ImportError:
        print('[WARNING] tensorboard not available; skipping tb plots.')
        return
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    acc = EventAccumulator(src_dir)
    acc.Reload()
    for tag in acc.Tags().get('scalars', []):
        if keys and tag not in keys:
            continue
        events = acc.Scalars(tag)
        x = np.asarray([e.step for e in events])
        y = np.asarray([e.value for e in events])
        if window and len(y) > window:
            x, y = window_func(x, y, window, np.mean)
        plt.figure()
        plt.plot(x, y)
        plt.xlabel(xlabel)
        plt.ylabel(tag)
        plt.savefig(os.path.join(out_dir, tag.replace('/', '_') + '.png'))
        plt.close()


def plot_from_experiments(legend_dir_specs, out_path='temp.png',
                          scalar_name=None, title='Traing Curves',
                          xlabel='Epochs', ylabel='Loss', window=None,
                          x_num_max=None, num_std=1, cols_per_row=3):
    """Multi-seed aggregated curves with std band."""
    plt = _plt()
    assert scalar_name is not None
    plt.figure()
    for legend, dirs in legend_dir_specs.items():
        runs = []
        for d in dirs:
            data = load_from_logs(d)
            if scalar_name in data:
                _, x, _, y = data[scalar_name]
                runs.append([x, y])
        if not runs:
            continue
        runs = align_runs(runs, x_num_max=x_num_max)
        if window:
            runs = smooth_runs(runs, window=window)
        x, ys = interpolate_runs(runs)
        mean = ys.mean(0)
        std = ys.std(0)
        plt.plot(x, mean, label=legend)
        plt.fill_between(x, mean - num_std * std, mean + num_std * std,
                         alpha=0.3)
    plt.title(title)
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.legend()
    plt.savefig(out_path)
    plt.close()


def get_log_dirs(all_logdirs, legend=None, select=None, exclude=None):
    """Expand log dir specs."""
    logdirs = []
    for logdir in all_logdirs:
        if os.path.isdir(logdir) and logdir[-1] == os.sep:
            logdirs += [logdir]
        else:
            basedir = os.path.dirname(logdir)

            def fulldir(x):
                return os.path.join(basedir, x)

            prefix = os.path.basename(logdir)
            listdir = os.listdir(basedir)
            logdirs += sorted([fulldir(x) for x in listdir
                               if prefix in x])
    if select is not None:
        logdirs = [d for d in logdirs if all(x in d for x in select)]
    if exclude is not None:
        logdirs = [d for d in logdirs if all(x not in d for x in exclude)]
    return logdirs
