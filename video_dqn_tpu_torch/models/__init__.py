"""Models of the port: ResNet18 and ResNet-50 stages, the HabitatDQN Q-net,
the inverse model, the Mask R-CNN detector and the weight bridge."""
