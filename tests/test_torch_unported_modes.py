"""The trainer modes the port does not take: ``BaseTrainer`` refuses each
with a message that names its ROADMAP item (Queue 1 item 11, parallel
modes), as ``tests/test_torch_estimator.py`` holds the DiscreteAR
message to item 6."""
import pytest

from vae_gslm_tpu_torch.hparams.hp import Hparams
from vae_gslm_tpu_torch.training.trainer import _UNPORTED_MODES, BaseTrainer


@pytest.mark.parametrize("mode", _UNPORTED_MODES)
def test_unported_trainer_modes_name_their_roadmap_item(mode):
    hp = Hparams.from_dict({"model": {}, "data": {},
                            "trainer": {mode: 2}})
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 11\)"):
        BaseTrainer(hp)

