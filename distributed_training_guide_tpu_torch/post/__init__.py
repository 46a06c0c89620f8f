"""On-policy post-training, in PyTorch: the trainer drives the serve engine.

Counterpart of ``distributed_training_guide_tpu/post``. The loop:

    rollout  — a co-resident ServeEngine generates variable-length samples
               under the paged pool, reproducible per derived seed,
               ledgered per sample (post/rollout.py);
    score    — programmatic rewards, reward-model forwards or teacher
               distributions behind one Scorer interface (post/score.py);
    update   — the masked ragged post step: rollouts packed by
               group_sizes through the grouped matmul (K5), prompt tokens
               masked, REINFORCE with a baseline or distillation KL behind
               post_loss, LoRA-sized updates (train/step.py);
    publish  — the refreshed policy copied into the engine
               (ServeEngine.publish_params, or publish_adapter into a pool
               slot), gated on the step guard so a NaN update never
               reaches the serving policy (post/loop.py).

CLI: ``python -m distributed_training_guide_tpu_torch.post`` (post/cli.py).
"""
from .loop import (PostTrainingLoop, merged_params, pack_rollouts,
                   publish_trained_adapter, qlora_base)
from .rollout import (Rollout, RolloutLedger, generate_rollouts,
                      rollout_seed)
from .score import (band_reward, match_reward, ProgrammaticScorer,
                    RewardModelScorer, Score, Scorer, TeacherScorer)

__all__ = [
    "PostTrainingLoop", "merged_params", "pack_rollouts",
    "publish_trained_adapter", "qlora_base",
    "Rollout", "RolloutLedger", "generate_rollouts", "rollout_seed",
    "ProgrammaticScorer", "RewardModelScorer", "Score", "Scorer",
    "TeacherScorer", "band_reward", "match_reward",
]
