"""Feature-channel schema shared by the generator and the engine."""
