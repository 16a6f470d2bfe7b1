from setuptools import find_packages, setup

setup(
    name="swiftllm-tpu",
    version="0.1.0",
    description="A TPU-native LLM serving framework (JAX/XLA/Pallas): paged attention, SARATHI scheduling, TP/DP/multi-host, quant, prefix caching, multi-LoRA, OpenAI API",
    packages=find_packages(include=["swiftllm_tpu", "swiftllm_tpu.*",
                                    "swiftllm_tpu_torch", "swiftllm_tpu_torch.*"]),
    python_requires=">=3.10",
)
