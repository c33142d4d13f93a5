"""Core library: LFTJ, boxing and the streaming triangle engine."""
