"""The zoo's refusal of ``pretrained=True``: the port ships no weights and
downloads nothing. The reference's factories accept the flag and return
random weights (ROADMAP queue 3); the port's raise."""


def refuse(pretrained):
    if pretrained:
        raise NotImplementedError(
            "pretrained=True: paddle_tpu_torch ships no pretrained weights "
            "and downloads nothing; build the model and load a state_dict "
            "with set_state_dict")
