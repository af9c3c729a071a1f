"""Training callbacks: periodic verification.

The port's own copy of `msml_tpu/core/callbacks.py::CallBackVerification`
(reference `utils/utils_callbacks.py:13-52`): every `frequency` steps run
LFW / CFP / AgeDB verification through `eval.verification.test` (flip-sum +
10-fold ROC), track the best accuracy per target and log XNorm,
Accuracy-Flip and Accuracy-Highest in the reference's words. Checkpoints
are `core/checkpoint.py`'s.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, List, Optional, Sequence

from msml_torch.core.logging import LOGGER


class CallBackVerification:
    """utils/utils_callbacks.py:13-52. extract_fn takes normalized float32
    NHWC numpy batches and returns (batch, D) embeddings."""

    def __init__(self, frequency: int, val_targets: Sequence[str],
                 rec_prefix: str, extract_fn: Callable,
                 image_size=(112, 112), is_gray: bool = False,
                 use_norm: bool = True, batch_size: int = 40,
                 logger: Optional[logging.Logger] = None):
        self.frequency = frequency
        self.extract_fn = extract_fn
        self.is_gray = is_gray
        self.use_norm = use_norm
        self.batch_size = batch_size
        self.logger = logger or logging.getLogger(LOGGER)
        self.highest_acc_list: List[float] = [0.0] * len(val_targets)
        self.ver_list = []
        self.ver_name_list = []
        self._init_dataset(val_targets, rec_prefix, image_size)

    def _init_dataset(self, val_targets, data_dir, image_size):
        """utils/utils_callbacks.py:40-46."""
        from msml_torch.data.bin_loader import load_bin

        for name in val_targets:
            path = os.path.join(data_dir, name + ".bin")
            if os.path.exists(path):
                self.ver_list.append(load_bin(path, image_size))
                self.ver_name_list.append(name)
            else:
                self.logger.warning("verification bin %s not found", path)

    def ver_test(self, global_step: int):
        """utils/utils_callbacks.py:26-38."""
        from msml_torch.eval.verification import test

        results = []
        for i, (data_list, issame) in enumerate(self.ver_list):
            acc2, std2, xnorm, _ = test(data_list, issame, self.extract_fn,
                                        self.batch_size, is_gray=self.is_gray,
                                        use_norm=self.use_norm)
            self.logger.info("[%s][%d]XNorm: %f" % (
                self.ver_name_list[i], global_step, xnorm))
            self.logger.info("[%s][%d]Accuracy-Flip: %1.5f+-%1.5f" % (
                self.ver_name_list[i], global_step, acc2, std2))
            if acc2 > self.highest_acc_list[i]:
                self.highest_acc_list[i] = acc2
            self.logger.info("[%s][%d]Accuracy-Highest: %1.5f" % (
                self.ver_name_list[i], global_step,
                self.highest_acc_list[i]))
            results.append(acc2)
        return results

    def __call__(self, num_update: int):
        if self.ver_list and num_update > 0 and \
                num_update % self.frequency == 0:
            return self.ver_test(num_update)
        return None
