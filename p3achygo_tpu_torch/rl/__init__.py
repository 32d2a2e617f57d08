"""The actor-learner slice: self-play -> replay -> train."""
