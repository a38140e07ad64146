"""Models of the port: ResNet18, the HabitatDQN Q-net and the weight bridge."""
