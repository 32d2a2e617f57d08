"""The RL loops: the actor-learner slice and the generation loop."""
